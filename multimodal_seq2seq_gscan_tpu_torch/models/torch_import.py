"""Import reference PyTorch checkpoints (.pth.tar) into the port's params.

The port of the JAX package's ``models/torch_import.py``: a user of the
reference implementation runs its checkpoints on the port without
retraining. It maps the reference ``Model`` state dict (seq2seq/model.py
parameter naming) onto :class:`ModelParams`, with the layout differences:

- Linear weights transpose (``[out, in]`` -> ``[in, out]``);
- conv kernels go to HWIO **with the spatial transpose**: the reference
  convolves with H and W swapped (cnn_model.py ``transpose(1, 3)``), so its
  learned kernels act spatially transposed;
- LSTM weights keep PyTorch's ``[4H, in]`` layout and gate order i, f, g, o
  (the port's cell uses the same), the backward direction of the
  bidirectional encoder from the ``_reverse`` entries.
"""

from typing import Dict, Tuple, Union

import torch

from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.params import (
    AttentionParams, CNNParams, DecoderParams, EncoderParams, LSTMLayerParams,
    ModelParams)


def params_from_state_dict(state_dict: Dict[str, torch.Tensor],
                           config: ModelConfig,
                           device: Union[str, torch.device] = "cuda"
                           ) -> ModelParams:
    """ModelParams (float32, contiguous, on ``device``) from a reference
    ``Model`` state dict."""

    def get(name: str) -> torch.Tensor:
        return state_dict[name].detach().to(device=device,
                                            dtype=torch.float32)

    def linear(name: str) -> torch.Tensor:
        return get(name).T.contiguous()

    def conv(name: str) -> torch.Tensor:
        # [O, C, kh, kw] -> [kw, kh, C, O]: HWIO with the spatial transpose
        # that mirrors the reference's transpose(1, 3) around its conv.
        return get(name).permute(3, 2, 1, 0).contiguous()

    def lstm(prefix: str, num_layers: int, reverse: bool = False
             ) -> Tuple[LSTMLayerParams, ...]:
        suffix = "_reverse" if reverse else ""
        return tuple(LSTMLayerParams(
            w_ih=get("{}.weight_ih_l{}{}".format(prefix, i, suffix)),
            w_hh=get("{}.weight_hh_l{}{}".format(prefix, i, suffix)),
            b_ih=get("{}.bias_ih_l{}{}".format(prefix, i, suffix)),
            b_hh=get("{}.bias_hh_l{}{}".format(prefix, i, suffix)))
            for i in range(num_layers))

    def attention(prefix: str) -> AttentionParams:
        return AttentionParams(
            key_w=linear(prefix + ".key_layer.weight"),
            query_w=linear(prefix + ".query_layer.weight"),
            energy_w=linear(prefix + ".energy_layer.weight"))

    conditional = config.conditional_attention
    return ModelParams(
        cnn=CNNParams(
            conv1_w=conv("situation_encoder.conv_1.weight"),
            conv1_b=get("situation_encoder.conv_1.bias"),
            conv5_w=conv("situation_encoder.conv_2.weight"),
            conv5_b=get("situation_encoder.conv_2.bias"),
            convk_w=conv("situation_encoder.conv_3.weight"),
            convk_b=get("situation_encoder.conv_3.bias")),
        encoder=EncoderParams(
            embedding=get("encoder.embedding.weight"),
            fwd_layers=lstm("encoder.lstm", config.num_encoder_layers),
            bwd_layers=(lstm("encoder.lstm", config.num_encoder_layers,
                             reverse=True)
                        if config.encoder_bidirectional else None)),
        enc_to_dec_w=linear("enc_hidden_to_dec_hidden.weight"),
        enc_to_dec_b=get("enc_hidden_to_dec_hidden.bias"),
        textual_attention=attention("textual_attention"),
        visual_attention=attention("visual_attention"),
        decoder=DecoderParams(
            embedding=get("attention_decoder.embedding.weight"),
            lstm_layers=lstm("attention_decoder.lstm",
                             config.num_decoder_layers),
            queries_to_keys_w=(
                linear("attention_decoder.queries_to_keys.weight")
                if conditional else None),
            queries_to_keys_b=(
                get("attention_decoder.queries_to_keys.bias")
                if conditional else None),
            output_to_hidden_w=linear(
                "attention_decoder.output_to_hidden.weight"),
            hidden_to_output_w=linear(
                "attention_decoder.hidden_to_output.weight")))


def load_reference_checkpoint(path: str, config: ModelConfig,
                              device: Union[str, torch.device] = "cuda"
                              ) -> Tuple[ModelParams, dict]:
    """(params on ``device``, metadata) of a reference checkpoint.pth.tar,
    read on the CPU first (``map_location="cpu"``)."""
    checkpoint = torch.load(path, map_location="cpu", weights_only=False)
    params = params_from_state_dict(checkpoint["state_dict"], config, device)
    meta = {
        "iteration": checkpoint.get("iteration", 0),
        "best_iteration": checkpoint.get("best_iteration", 0),
        "best_accuracy": checkpoint.get("best_accuracy", 0.0),
        "best_exact_match": checkpoint.get("best_exact_match", 0.0),
    }
    return params, meta
