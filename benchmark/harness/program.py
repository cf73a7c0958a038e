"""The benchmark's one point of contact with the program's containers:
the port's parameter tree, built from and read back into the named leaves
of ``harness/weights.py``, and its model configuration."""

from typing import Dict

import torch


def model_params(W: Dict[str, torch.Tensor]):
    """The port's ``ModelParams`` of the named leaves (the same tensors)."""
    from multimodal_seq2seq_gscan_tpu_torch.models.params import (
        AttentionParams, CNNParams, DecoderParams, EncoderParams,
        LSTMLayerParams, ModelParams)

    def lstm(prefix):
        return (LSTMLayerParams(*(W["{}.0.{}".format(prefix, f)]
                                  for f in LSTMLayerParams._fields)),)

    def attention(prefix):
        return AttentionParams(*(W["{}.{}".format(prefix, f)]
                                 for f in AttentionParams._fields))

    return ModelParams(
        cnn=CNNParams(*(W["cnn." + f] for f in CNNParams._fields)),
        encoder=EncoderParams(W["encoder.embedding"],
                              lstm("encoder.fwd_layers"),
                              lstm("encoder.bwd_layers")),
        enc_to_dec_w=W["enc_to_dec_w"], enc_to_dec_b=W["enc_to_dec_b"],
        textual_attention=attention("textual_attention"),
        visual_attention=attention("visual_attention"),
        decoder=DecoderParams(
            W["decoder.embedding"], lstm("decoder.lstm_layers"),
            W["decoder.queries_to_keys_w"], W["decoder.queries_to_keys_b"],
            W["decoder.output_to_hidden_w"],
            W["decoder.hidden_to_output_w"]))


def named(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tensors of a port tree under the JAX names."""
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree}
    if tree is None:
        return {}
    items = (zip(tree._fields, tree) if hasattr(tree, "_fields")
             else ((str(i), v) for i, v in enumerate(tree)))
    out = {}
    for key, value in items:
        out.update(named(value, prefix + key + "."))
    return out


def model_config(cfg: dict, input_vocabulary: int, target_vocabulary: int,
                 channels: int):
    """The port's ``ModelConfig`` of a configuration file, the kernels on
    (``teacher_forced_impl`` "fused")."""
    from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
    fields = ("embedding_dimension", "encoder_hidden_size",
              "decoder_hidden_size", "num_encoder_layers",
              "num_decoder_layers", "encoder_bidirectional",
              "cnn_kernel_size", "cnn_hidden_num_channels",
              "encoder_dropout_p", "decoder_dropout_p", "cnn_dropout_p",
              "conditional_attention", "auxiliary_task", "attention_type")
    return ModelConfig(
        input_vocabulary_size=input_vocabulary,
        target_vocabulary_size=target_vocabulary,
        num_cnn_channels=channels, teacher_forced_impl="fused",
        input_padding_idx=0, target_pad_idx=0, target_sos_idx=1,
        target_eos_idx=2, **{f: cfg[f] for f in fields})


def load_kernels(device: str):
    """Load the port's kernel library (built on the first run in a
    checkout, under its ``build/``), so that set-up holds the build."""
    if device == "cuda":
        from multimodal_seq2seq_gscan_tpu_torch.ops import _build
        _build.library()
