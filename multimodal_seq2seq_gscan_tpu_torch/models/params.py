"""Parameter containers (NamedTuples of torch tensors), their initialisation
and the tree helpers that map over them.

The layouts are the JAX package's (``multimodal_seq2seq_gscan_tpu/models/
params.py``), so weights cross between the two packages without reshaping:
- Linear: ``[in, out]`` for right-multiplication;
- LSTM: ``[4H, in]`` with gate order i, f, g, o;
- conv: HWIO ``[kh, kw, C, O]`` (``nn.situation_cnn`` re-lays it for
  ``F.conv2d``);
- embedding: ``[V, E]``.
"""

import math
from typing import (Any, Callable, List, Mapping, NamedTuple, Optional,
                    Tuple, Union)

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


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a params tree, in field order (None fields skipped)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in leaves(item)]
    return []


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensors of one or more params trees of the same
    structure (a NamedTuple keeps its type; None stays None)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if tree is None:
        return None
    mapped = [tree_map(fn, *items) for items in zip(tree, *rest)]
    return type(tree)(*mapped) if hasattr(tree, "_fields") else tuple(mapped)


def tree_unflatten(tree, values: List[torch.Tensor]):
    """A tree of ``tree``'s structure whose tensors are ``values``, taken in
    the order of :func:`leaves`."""
    values = iter(values)
    return tree_map(lambda _: next(values), tree)


def params_to_numpy(tree) -> Tree:
    """The inverse of :func:`params_from_numpy`: nested dicts of float32
    numpy arrays under the JAX field names, a layer stack as ``{"0": ...}``
    (the layout flax writes)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().astype(np.float32)
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return {name: params_to_numpy(value)
                for name, value in zip(tree._fields, tree)}
    return {str(i): params_to_numpy(value) for i, value in enumerate(tree)}


def count_parameters(params: ModelParams) -> int:
    return sum(leaf.numel() for leaf in leaves(params))


# Initialisation (the JAX package's ``models/params.py:60-190``): the same
# distributions, PyTorch's defaults, drawn from a torch.Generator (so the
# bits differ from JAX's):
# - Linear and conv: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias;
# - LSTM: U(-1/sqrt(H), 1/sqrt(H)) for every weight and bias;
# - embedding: N(0, 1) with the padding row zeroed.


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def _linear(gen, in_features, out_features, bias=True):
    bound = 1.0 / math.sqrt(in_features)
    w = _uniform(gen, (in_features, out_features), bound)
    return (w, _uniform(gen, (out_features,), bound)) if bias else w


def _lstm_layer(gen, input_size, hidden) -> LSTMLayerParams:
    bound = 1.0 / math.sqrt(hidden)
    return LSTMLayerParams(
        w_ih=_uniform(gen, (4 * hidden, input_size), bound),
        w_hh=_uniform(gen, (4 * hidden, hidden), bound),
        b_ih=_uniform(gen, (4 * hidden,), bound),
        b_hh=_uniform(gen, (4 * hidden,), bound))


def _embedding(gen, vocab, dim, padding_idx):
    emb = torch.randn((vocab, dim), generator=gen)
    emb[padding_idx] = 0.0
    return emb


def _conv(gen, k, in_channels, out_channels):
    bound = 1.0 / math.sqrt(in_channels * k * k)
    return (_uniform(gen, (k, k, in_channels, out_channels), bound),
            _uniform(gen, (out_channels,), bound))


def _attention(gen, key_size, query_size, hidden) -> AttentionParams:
    return AttentionParams(key_w=_linear(gen, key_size, hidden, bias=False),
                           query_w=_linear(gen, query_size, hidden,
                                           bias=False),
                           energy_w=_linear(gen, hidden, 1, bias=False))


def init_model_params(config, generator: torch.Generator,
                      device: Union[str, torch.device] = "cuda"
                      ) -> ModelParams:
    """Fresh parameters for ``config`` (a ``ModelConfig``), drawn on the CPU
    from ``generator`` and placed on ``device``."""
    c, gen = config, generator
    conv1 = _conv(gen, 1, c.num_cnn_channels, c.cnn_hidden_num_channels)
    conv5 = _conv(gen, 5, c.num_cnn_channels, c.cnn_hidden_num_channels)
    convk = _conv(gen, c.cnn_kernel_size, c.num_cnn_channels,
                  c.cnn_hidden_num_channels)
    directions = 2 if c.encoder_bidirectional else 1

    def enc_in(i):
        return (c.embedding_dimension if i == 0
                else directions * c.encoder_hidden_size)

    def enc_stack():
        return tuple(_lstm_layer(gen, enc_in(i), c.encoder_hidden_size)
                     for i in range(c.num_encoder_layers))

    encoder = EncoderParams(
        embedding=_embedding(gen, c.input_vocabulary_size,
                             c.embedding_dimension, c.input_padding_idx),
        fwd_layers=enc_stack(),
        bwd_layers=enc_stack() if c.encoder_bidirectional else None)
    enc_to_dec_w, enc_to_dec_b = _linear(gen, c.encoder_hidden_size,
                                         c.decoder_hidden_size)
    h = c.decoder_hidden_size
    textual = _attention(gen, c.encoder_hidden_size, h, h)
    visual = _attention(gen, c.cnn_output_dimension, h, h)
    dec_embedding = _embedding(gen, c.target_vocabulary_size, h,
                               c.target_pad_idx)
    dec_layers = tuple(_lstm_layer(gen, 3 * h if i == 0 else h, h)
                       for i in range(c.num_decoder_layers))
    q2k_w, q2k_b = (_linear(gen, 2 * h, h) if c.conditional_attention
                    else (None, None))
    params = ModelParams(
        cnn=CNNParams(*conv1, *conv5, *convk),
        encoder=encoder, enc_to_dec_w=enc_to_dec_w,
        enc_to_dec_b=enc_to_dec_b, textual_attention=textual,
        visual_attention=visual,
        decoder=DecoderParams(
            embedding=dec_embedding, lstm_layers=dec_layers,
            queries_to_keys_w=q2k_w, queries_to_keys_b=q2k_b,
            output_to_hidden_w=_linear(gen, 4 * h, h, bias=False),
            hidden_to_output_w=_linear(gen, h, c.target_vocabulary_size,
                                       bias=False)))
    return tree_map(lambda t: t.to(device), params)
