"""The multimodal seq2seq model, inference path: encoder and one decoder step.

PyTorch counterparts of ``encode_input``, ``initialize_decoder_hidden``,
``project_keys`` and ``decoder_step`` in the JAX package's
``models/model.py``: the same tensor algebra, batch-first, deterministic (no
dropout). Training-only functions wait for the training slice.
"""

from typing import NamedTuple, Tuple

import torch

from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.nn import (
    additive_attention, embed, lstm_cell, masked_lstm_scan, reverse_padded,
    sequence_mask, situation_cnn)
from multimodal_seq2seq_gscan_tpu_torch.models.params import ModelParams


class EncodedInput(NamedTuple):
    encoded_situations: torch.Tensor  # [B, H*W, 3*cnn_channels]
    encoded_commands: torch.Tensor    # [B, T_in, enc_hidden]
    hidden: torch.Tensor              # [B, enc_hidden]
    command_mask: torch.Tensor        # [B, T_in]


def encode_input(params: ModelParams, config: ModelConfig,
                 command_ids: torch.Tensor, command_lengths: torch.Tensor,
                 situations: torch.Tensor) -> EncodedInput:
    """CNN over the situation grid + (bi)LSTM over the command tokens.

    The two directions' outputs and final hidden states are summed (reference
    seq2seq_model.py:76-81); the backward pass runs over the length-reversed
    valid prefix, which reproduces packed-sequence semantics.
    """
    features = torch.relu(situation_cnn(params.cnn, situations,
                                        config.cnn_kernel_size))
    embedded = embed(params.encoder.embedding, command_ids,
                     config.input_padding_idx)
    mask = sequence_mask(command_lengths, command_ids.shape[1])

    # torch nn.LSTM stack wiring: layer i>0 consumes the concat of both
    # directions of the layer below; the direction *sum* is the last layer's.
    layer_input = embedded
    fwd_out = bwd_out = fwd_h = bwd_h = None
    for i, fwd_layer in enumerate(params.encoder.fwd_layers):
        fwd_out, (fwd_h, _) = masked_lstm_scan(fwd_layer, layer_input, mask)
        if params.encoder.bwd_layers is not None:
            reversed_in = reverse_padded(layer_input, command_lengths)
            bwd_out_rev, (bwd_h, _) = masked_lstm_scan(
                params.encoder.bwd_layers[i], reversed_in, mask)
            bwd_out = reverse_padded(bwd_out_rev, command_lengths)
            layer_input = torch.cat([fwd_out, bwd_out], dim=-1)
        else:
            layer_input = fwd_out
    if params.encoder.bwd_layers is not None:
        outputs = fwd_out + bwd_out
        hidden = fwd_h + bwd_h
    else:
        outputs = fwd_out
        hidden = fwd_h
    return EncodedInput(encoded_situations=features, encoded_commands=outputs,
                        hidden=hidden, command_mask=mask)


def initialize_decoder_hidden(params: ModelParams, config: ModelConfig,
                              encoder_hidden: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tanh(W enc_hidden + b) replicated into (h0, c0) for every decoder layer.

    Returns h, c of shape [num_layers, B, H].
    """
    message = torch.tanh(encoder_hidden @ params.enc_to_dec_w
                         + params.enc_to_dec_b)
    stacked = message[None].expand(
        (config.num_decoder_layers,) + tuple(message.shape)).contiguous()
    return stacked, stacked.clone()


def project_keys(params: ModelParams, encoded: EncodedInput
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project both attention key sets once per sequence. The projected keys
    are also the attention *values*: contexts live in decoder-hidden space."""
    projected_textual = encoded.encoded_commands @ params.textual_attention.key_w
    projected_visual = (encoded.encoded_situations
                        @ params.visual_attention.key_w)
    return projected_textual, projected_visual


def decoder_step(params: ModelParams, config: ModelConfig,
                 token_ids: torch.Tensor,
                 hidden: Tuple[torch.Tensor, torch.Tensor],
                 projected_textual_keys: torch.Tensor,
                 command_mask: torch.Tensor,
                 projected_visual_keys: torch.Tensor):
    """One decoder step (reference BahdanauAttentionDecoderRNN.forward_step).

    token_ids: [B]; hidden: (h, c) each [num_layers, B, H].
    Returns (logits [B, V], (h, c), attn_commands [B, M_t],
    attn_situations [B, M_v]). Both attentions go through
    ``ops.additive_attention`` (kernel 1 on the card).
    """
    h_stack, c_stack = hidden
    query = h_stack[-1]  # top-layer hidden state drives attention

    embedded = embed(params.decoder.embedding, token_ids,
                     config.target_pad_idx)
    context_command, attn_commands = additive_attention(
        params.textual_attention, query, projected_textual_keys, command_mask)

    if config.conditional_attention:
        joint = torch.cat([query, context_command], dim=-1)
        visual_query = torch.tanh(joint @ params.decoder.queries_to_keys_w
                                  + params.decoder.queries_to_keys_b)
    else:
        visual_query = query
    # The visual memory has no padding: every grid cell is valid.
    context_situation, attn_situations = additive_attention(
        params.visual_attention, visual_query, projected_visual_keys, None)

    layer_input = torch.cat([embedded, context_command, context_situation],
                            dim=-1)                                  # [B, 3H]
    new_h, new_c = [], []
    for i, layer in enumerate(params.decoder.lstm_layers):
        h_i, c_i = lstm_cell(layer, layer_input, h_stack[i], c_stack[i])
        new_h.append(h_i)
        new_c.append(c_i)
        layer_input = h_i
    hidden_out = (torch.stack(new_h), torch.stack(new_c))

    pre_output = torch.cat(
        [embedded, new_h[-1], context_command, context_situation], dim=-1)
    pre_output = pre_output @ params.decoder.output_to_hidden_w     # [B, H]
    logits = pre_output @ params.decoder.hidden_to_output_w         # [B, V]
    return logits, hidden_out, attn_commands, attn_situations


def auxiliary_task_forward(summed_attention: torch.Tensor) -> torch.Tensor:
    """Log-softmax over grid cells of the time-summed situation attention."""
    return torch.log_softmax(summed_attention, dim=-1)
