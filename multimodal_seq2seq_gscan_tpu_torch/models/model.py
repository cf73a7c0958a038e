"""The multimodal seq2seq model: CNN + BiLSTM encoder, joint-attention decoder.

PyTorch counterparts of the JAX package's ``models/model.py``: the same
tensor algebra, batch-first. Dropout draws from an explicit
``torch.Generator`` in a fixed order (CNN features, encoder embedding, the
encoder's inter-layer masks, then one ``[T, B, E]`` mask for the decoder's
embedded tokens and, for a decoder of several layers, one
``[T, L - 1, B, H]`` mask between its layers), so a generator seeded alike
gives every teacher-forced implementation the same noise.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from multimodal_seq2seq_gscan_tpu_torch.models.config import (
    TEACHER_FORCED_IMPLS, ModelConfig, decoder_impl)
from multimodal_seq2seq_gscan_tpu_torch.models.nn import (
    additive_attention, dropout, embed, lstm_cell, masked_lstm_scan,
    reverse_padded, sequence_mask, situation_cnn, uniform)
from multimodal_seq2seq_gscan_tpu_torch.models.params import ModelParams
from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf_ops
from multimodal_seq2seq_gscan_tpu_torch.ops.decode_block import (
    pack_decoder_weights)


class EncodedInput(NamedTuple):
    encoded_situations: torch.Tensor  # [B, H*W, 3*cnn_channels]
    encoded_commands: torch.Tensor    # [B, T_in, enc_hidden]
    hidden: torch.Tensor              # [B, enc_hidden]
    command_mask: torch.Tensor        # [B, T_in]


def encode_input(params: ModelParams, config: ModelConfig,
                 command_ids: torch.Tensor, command_lengths: torch.Tensor,
                 situations: torch.Tensor, *,
                 generator: Optional[torch.Generator] = None,
                 deterministic: bool = True) -> EncodedInput:
    """CNN over the situation grid + (bi)LSTM over the command tokens.

    The two directions' outputs and final hidden states are summed (reference
    seq2seq_model.py:76-81); the backward pass runs over the length-reversed
    valid prefix, which reproduces packed-sequence semantics. Dropout (CNN
    features, the embedded command, then each layer's output but the
    last's, as torch nn.LSTM's inter-layer dropout) draws from
    ``generator`` unless ``deterministic``.
    """
    features = torch.relu(situation_cnn(params.cnn, situations,
                                        config.cnn_kernel_size))
    features = dropout(generator, features, config.cnn_dropout_p,
                       deterministic)
    embedded = embed(params.encoder.embedding, command_ids,
                     config.input_padding_idx)
    embedded = dropout(generator, embedded, config.encoder_dropout_p,
                       deterministic)
    mask = sequence_mask(command_lengths, command_ids.shape[1])

    # torch nn.LSTM stack wiring: layer i>0 consumes the concat of both
    # directions of the layer below; the direction *sum* is the last layer's.
    num_layers = len(params.encoder.fwd_layers)
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
        if i < num_layers - 1:
            layer_input = dropout(generator, layer_input,
                                  config.encoder_dropout_p, deterministic)
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
                 projected_visual_keys: torch.Tensor,
                 drop: Optional[torch.Tensor] = None,
                 layer_drop: Optional[torch.Tensor] = None):
    """One decoder step (reference BahdanauAttentionDecoderRNN.forward_step).

    token_ids: [B]; hidden: (h, c) each [num_layers, B, H]; drop: an optional
    [B, E] multiplicative dropout mask on the embedded token; layer_drop: an
    optional [num_layers - 1, B, H] one on each layer's output but the
    last's, where it feeds the next layer (torch nn.LSTM's inter-layer
    dropout; the carried state is not dropped).
    Returns (logits [B, V], (h, c), attn_commands [B, M_t],
    attn_situations [B, M_v]). Both attentions go through
    ``ops.additive_attention`` (kernel 1 on the card), whose outputs are
    float32 whatever the keys' dtype: in a bf16 decode loop
    (``decode/greedy.py``) the contexts go back to the query's dtype, and
    a product of two dtypes runs in the wider one, as JAX promotes.
    """
    h_stack, c_stack = hidden
    query = h_stack[-1]  # top-layer hidden state drives attention

    embedded = embed(params.decoder.embedding, token_ids,
                     config.target_pad_idx)
    if drop is not None:
        embedded = embedded * drop
    context_command, attn_commands = additive_attention(
        params.textual_attention, query, projected_textual_keys, command_mask)
    context_command = context_command.to(query.dtype)

    if config.conditional_attention:
        joint = torch.cat([query, context_command], dim=-1)
        visual_query = torch.tanh(joint @ params.decoder.queries_to_keys_w
                                  + params.decoder.queries_to_keys_b)
    else:
        visual_query = query
    # The visual memory has no padding: every grid cell is valid.
    context_situation, attn_situations = additive_attention(
        params.visual_attention, visual_query, projected_visual_keys, None)
    context_situation = context_situation.to(query.dtype)

    layer_input = torch.cat([embedded, context_command, context_situation],
                            dim=-1)                                  # [B, 3H]
    new_h, new_c = [], []
    for i, layer in enumerate(params.decoder.lstm_layers):
        h_i, c_i = lstm_cell(layer, layer_input, h_stack[i], c_stack[i])
        new_h.append(h_i)
        new_c.append(c_i)
        layer_input = h_i
        if layer_drop is not None and i < len(layer_drop):
            layer_input = layer_input * layer_drop[i]
    hidden_out = (torch.stack(new_h), torch.stack(new_c))

    pre_output = torch.cat(
        [embedded, new_h[-1], context_command, context_situation], dim=-1)
    pre_output = _product(pre_output,
                          params.decoder.output_to_hidden_w)       # [B, H]
    logits = _product(pre_output,
                      params.decoder.hidden_to_output_w)           # [B, V]
    return logits, hidden_out, attn_commands, attn_situations


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``, in the wider dtype of the two where they differ (the
    ``bfloat16_mixed`` decode's float32 head on bf16 activations)."""
    if x.dtype != w.dtype:
        dtype = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dtype), w.to(dtype)
    return x @ w


def decoder_drop_mask(config: ModelConfig, shape: Tuple[int, ...],
                      device, generator, deterministic: bool) -> torch.Tensor:
    """A decoder dropout mask of ``shape`` (``[T, B, E]`` on the embedded
    tokens, ``[T, L - 1, B, H]`` between layers; the batch is the axis
    before the last): ``keep / (1 - p)`` with ``keep ~ Bernoulli(1 - p)``,
    or ones (JAX ``models/model.py:272-277``). ``generator``: see
    ``nn.uniform``."""
    if deterministic or config.decoder_dropout_p == 0.0:
        return torch.ones(shape, device=device)
    keep = 1.0 - config.decoder_dropout_p
    return (uniform(generator, shape, device, len(shape) - 2)
            < keep).float() / keep


def decode_teacher_forced(params: ModelParams, config: ModelConfig,
                          target_ids: torch.Tensor, encoded: EncodedInput, *,
                          generator: Optional[torch.Generator] = None,
                          deterministic: bool = True):
    """Teacher-forced unroll over all T target positions.

    Returns log-probs [B, T, V] and the visual attention summed over *all*
    T steps, pad steps included (as the reference does) [B, M_v].
    ``config.teacher_forced_impl`` picks the unroll (see
    ``models/config.py``; without conditional attention, or with more than
    one decoder layer, ``"fused"`` and ``"plain"`` warn and take
    ``"step"``, ``decoder_impl``, as JAX's scan path takes them); all three
    draw the same dropout mask. ``"step"`` with several layers also draws
    the inter-layer mask, after the embedded tokens'.
    """
    impl = config.teacher_forced_impl
    if impl not in TEACHER_FORCED_IMPLS:
        raise ValueError("teacher_forced_impl must be one of {}, got "
                         "{!r}".format(TEACHER_FORCED_IMPLS, impl))
    impl = decoder_impl(config, impl, "teacher_forced_impl")
    projected_textual, projected_visual = project_keys(params, encoded)
    h, c = initialize_decoder_hidden(params, config, encoded.hidden)
    batch, steps = target_ids.shape
    tokens = target_ids.T.to(torch.int32).contiguous()             # [T, B]
    drop = decoder_drop_mask(
        config, (steps, batch, params.decoder.embedding.shape[1]),
        target_ids.device, generator, deterministic)
    if impl == "step":
        hidden = (h, c)
        layer_drop = [None] * steps
        if config.num_decoder_layers > 1 and not deterministic:
            layer_drop = decoder_drop_mask(
                config, (steps, config.num_decoder_layers - 1, batch,
                         h.shape[-1]),
                target_ids.device, generator, deterministic)
        logits, attention = [], []
        for t in range(steps):
            step_logits, hidden, _, attn_situations = decoder_step(
                params, config, tokens[t], hidden, projected_textual,
                encoded.command_mask, projected_visual, drop=drop[t],
                layer_drop=layer_drop[t])
            logits.append(step_logits)
            attention.append(attn_situations)
        logits = torch.stack(logits)
        summed_attention = torch.stack(attention).sum(dim=0)
    else:
        unroll = (tf_ops.fused_teacher_forced if impl == "fused"
                  else tf_ops.teacher_forced_plain)
        logits, summed_attention = unroll(
            projected_textual.contiguous(),
            encoded.command_mask.contiguous(),
            projected_visual.contiguous(), h[0], c[0], tokens, drop,
            pack_decoder_weights(params, config.target_pad_idx),
            num_steps=steps)
    log_probs = torch.log_softmax(logits.transpose(0, 1), dim=-1)
    return log_probs, summed_attention


def forward(params: ModelParams, config: ModelConfig,
            command_ids: torch.Tensor, command_lengths: torch.Tensor,
            situations: torch.Tensor, target_ids: torch.Tensor, *,
            generator: Optional[torch.Generator] = None,
            deterministic: bool = True):
    """Encode + teacher-forced decode (+ the aux head's scores)."""
    encoded = encode_input(params, config, command_ids, command_lengths,
                           situations, generator=generator,
                           deterministic=deterministic)
    log_probs, summed_attention = decode_teacher_forced(
        params, config, target_ids, encoded, generator=generator,
        deterministic=deterministic)
    if config.auxiliary_task:
        target_position_scores = auxiliary_task_forward(summed_attention)
    else:
        target_position_scores = torch.zeros_like(summed_attention)
    return log_probs, target_position_scores


def auxiliary_task_forward(summed_attention: torch.Tensor) -> torch.Tensor:
    """Log-softmax over grid cells of the time-summed situation attention."""
    return torch.log_softmax(summed_attention, dim=-1)


def remove_start_of_sequence(targets: torch.Tensor) -> torch.Tensor:
    """Shift targets left by one (drop SOS, append a pad column)."""
    return torch.cat([targets[:, 1:], torch.zeros_like(targets[:, :1])],
                     dim=1)


def get_loss(config: ModelConfig, target_log_probs: torch.Tensor,
             targets: torch.Tensor,
             total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NLL averaged over non-pad target tokens (NLLLoss(ignore_index=pad)):
    the batch's sum over ``total`` (by default its own count of non-pad
    tokens, at least 1; a sharded step passes the global batch's)."""
    targets = remove_start_of_sequence(targets).long()
    token_log_probs = torch.gather(target_log_probs, -1,
                                   targets[..., None])[..., 0]      # [B, T]
    mask = (targets != config.target_pad_idx).to(target_log_probs.dtype)
    if total is None:
        total = torch.clamp(mask.sum(), min=1.0)
    return -(token_log_probs * mask).sum() / total


def metric_counts(config: ModelConfig, target_log_probs: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    """``[correct tokens, non-pad tokens, exactly matched rows, rows with a
    target]`` of the batch (int64); all-pad rows (the padding of a short
    batch) are left out of exact match."""
    targets = remove_start_of_sequence(targets).long()
    mask = targets != config.target_pad_idx
    correct = (torch.argmax(target_log_probs, dim=-1) == targets) & mask
    per_example_total = mask.sum(dim=1)
    valid_example = per_example_total > 0
    matched = (correct.sum(dim=1) == per_example_total) & valid_example
    return torch.stack([correct.sum(), mask.sum(), matched.sum(),
                        valid_example.sum()])


def metrics_from_counts(counts: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(token accuracy %, exact-match %) from ``metric_counts``."""
    accuracy = 100.0 * counts[0] / torch.clamp(counts[1], min=1)
    exact = 100.0 * counts[2] / torch.clamp(counts[3], min=1)
    return accuracy, exact


def auxiliary_counts(auxiliary_scores: torch.Tensor,
                     target_positions: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """``[rows whose target cell is the argmax, valid rows]`` (float32);
    ``valid`` masks padded batch rows."""
    valid = valid.float()
    correct = (torch.argmax(auxiliary_scores, dim=-1)
               == target_positions.long()).float()
    return torch.stack([(correct * valid).sum(), valid.sum()])


def get_metrics(config: ModelConfig, target_log_probs: torch.Tensor,
                targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(token accuracy %, exact-match %) over the batch."""
    return metrics_from_counts(metric_counts(config, target_log_probs,
                                             targets))


def get_auxiliary_loss(auxiliary_log_probs: torch.Tensor,
                       target_positions: torch.Tensor,
                       valid: Optional[torch.Tensor] = None,
                       total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NLL of the target grid cell; ``valid`` masks padded batch rows, and
    the sum goes over ``total`` (by default the count of valid rows, at
    least 1)."""
    token_log_probs = torch.gather(auxiliary_log_probs, -1,
                                   target_positions.long()[:, None])[:, 0]
    if valid is None:
        return -token_log_probs.mean()
    weights = valid.to(token_log_probs.dtype)
    if total is None:
        total = torch.clamp(weights.sum(), min=1.0)
    return -(token_log_probs * weights).sum() / total
