"""Parameter containers: NamedTuples of torch tensors.

The layouts are the JAX package's (``multimodal_seq2seq_gscan_tpu/models/
params.py``), so weights cross between the two packages without reshaping:
- Linear: ``[in, out]`` for right-multiplication;
- LSTM: ``[4H, in]`` with gate order i, f, g, o;
- conv: HWIO ``[kh, kw, C, O]`` (``nn.situation_cnn`` re-lays it for
  ``F.conv2d``);
- embedding: ``[V, E]``.
"""

from typing import Any, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch


class LSTMLayerParams(NamedTuple):
    w_ih: torch.Tensor  # [4H, input_size], gates ordered i, f, g, o
    w_hh: torch.Tensor  # [4H, H]
    b_ih: torch.Tensor  # [4H]
    b_hh: torch.Tensor  # [4H]


class AttentionParams(NamedTuple):
    key_w: torch.Tensor     # [key_size, hidden]
    query_w: torch.Tensor   # [query_size, hidden]
    energy_w: torch.Tensor  # [hidden, 1]


class EncoderParams(NamedTuple):
    embedding: torch.Tensor  # [input_vocab, embedding_dim]
    fwd_layers: Tuple[LSTMLayerParams, ...]
    bwd_layers: Optional[Tuple[LSTMLayerParams, ...]]


class DecoderParams(NamedTuple):
    embedding: torch.Tensor  # [target_vocab, H]
    lstm_layers: Tuple[LSTMLayerParams, ...]
    queries_to_keys_w: Optional[torch.Tensor]  # [2H, H] (conditional attention)
    queries_to_keys_b: Optional[torch.Tensor]  # [H]
    output_to_hidden_w: torch.Tensor  # [4H, H], bias-free
    hidden_to_output_w: torch.Tensor  # [H, target_vocab], bias-free


class CNNParams(NamedTuple):
    conv1_w: torch.Tensor  # [1, 1, C, O]  (HWIO layout)
    conv1_b: torch.Tensor
    conv5_w: torch.Tensor  # [5, 5, C, O]
    conv5_b: torch.Tensor
    convk_w: torch.Tensor  # [K, K, C, O]
    convk_b: torch.Tensor


class ModelParams(NamedTuple):
    cnn: CNNParams
    encoder: EncoderParams
    enc_to_dec_w: torch.Tensor  # [enc_hidden, dec_hidden]
    enc_to_dec_b: torch.Tensor  # [dec_hidden]
    textual_attention: AttentionParams
    visual_attention: AttentionParams
    decoder: DecoderParams


Tree = Mapping[str, Any]


def _layers(tree: Optional[Tree], convert
            ) -> Optional[Tuple[LSTMLayerParams, ...]]:
    """A layer stack, stored as flax stores a tuple: ``{"0": ..., "1": ...}``."""
    if tree is None:
        return None
    return tuple(LSTMLayerParams(**{name: convert(tree[str(i)][name])
                                    for name in LSTMLayerParams._fields})
                 for i in range(len(tree)))


def params_from_numpy(tree: Tree, device: Union[str, torch.device] = "cuda"
                      ) -> ModelParams:
    """Build ModelParams from the JAX package's params as nested numpy arrays.

    ``tree`` has the JAX field names as keys (the layout of
    ``flax.serialization.to_state_dict(params)`` and of the checkpoint's
    ``params`` map, where a tuple of layers is a ``{"0": ...}`` map). Every
    leaf becomes a float32 tensor on ``device``.
    """
    def convert(array) -> torch.Tensor:
        return torch.tensor(np.asarray(array, dtype=np.float32),
                            device=device)

    def optional(value):
        return None if value is None else convert(value)

    def attention(sub: Tree) -> AttentionParams:
        return AttentionParams(**{name: convert(sub[name])
                                  for name in AttentionParams._fields})

    enc = tree["encoder"]
    dec = tree["decoder"]
    return ModelParams(
        cnn=CNNParams(**{name: convert(tree["cnn"][name])
                         for name in CNNParams._fields}),
        encoder=EncoderParams(
            embedding=convert(enc["embedding"]),
            fwd_layers=_layers(enc["fwd_layers"], convert),
            bwd_layers=_layers(enc.get("bwd_layers"), convert)),
        enc_to_dec_w=convert(tree["enc_to_dec_w"]),
        enc_to_dec_b=convert(tree["enc_to_dec_b"]),
        textual_attention=attention(tree["textual_attention"]),
        visual_attention=attention(tree["visual_attention"]),
        decoder=DecoderParams(
            embedding=convert(dec["embedding"]),
            lstm_layers=_layers(dec["lstm_layers"], convert),
            queries_to_keys_w=optional(dec.get("queries_to_keys_w")),
            queries_to_keys_b=optional(dec.get("queries_to_keys_b")),
            output_to_hidden_w=convert(dec["output_to_hidden_w"]),
            hidden_to_output_w=convert(dec["hidden_to_output_w"])))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _leaves(item)


def count_parameters(params: ModelParams) -> int:
    return sum(leaf.numel() for leaf in _leaves(params))
