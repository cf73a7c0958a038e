"""Batched greedy decoding with early exit.

The port of ``make_greedy_decoder`` and ``strip_output_sequences`` from the
JAX package's ``decode/greedy.py`` (float32): encode the whole batch, project
both attention key sets once, then run the decoder for at most
``max_decoding_steps + 1`` steps (the reference's ``<=`` bound) with
per-example done flags. Steps run in blocks of ``exit_check_every``; after each
block one host check of ``done.all()`` ends the loop early, and the blocks it
skips leave zeros, as the JAX decoder's skipped blocks do.

``decode_impl`` picks how a block runs:
- ``"block"`` (default): one launch of kernel 2 (``ops/decode_block.py``)
  per block on the card;
- ``"block_plain"``: the same block through its plain PyTorch version, which
  also records every step's top-2 logit gap (``GreedyDecodeOutput.top2_gap``)
  so that a comparison can tell an argmax near-tie;
- ``"step"``: a loop over ``models.model.decoder_step``, whose two attentions
  are kernel 1 (``ops/additive_attention.py``) on the card.
On CPU tensors the kernels' wrappers take their plain versions.

``compute_dtype`` follows the JAX decoder's casts: ``None`` or
``"float32"`` (the default), ``"bfloat16"`` (the encoder runs in float32,
then the loop's params, projected keys, command mask and state are cast to
bf16), ``"bfloat16_mixed"`` (the same, with the output head kept in
float32) and ``"bfloat16_keys"`` (only the two projected key tensors are
stored in bf16; every other operand and all arithmetic stay float32). The
bf16 variants run ``"step"``: their attentions are kernel 1's bf16 form,
and a ``"block"`` or ``"block_plain"`` decode warns and falls back
(``models.config.decoder_impl``), as JAX falls back from its Pallas block.
The attention stacks come back in float32.
"""

from typing import List, NamedTuple, Optional, Tuple

import torch

from multimodal_seq2seq_gscan_tpu_torch.models.config import (
    ModelConfig, decoder_impl)
from multimodal_seq2seq_gscan_tpu_torch.models.model import (
    auxiliary_task_forward, decoder_step, encode_input,
    initialize_decoder_hidden, project_keys)
from multimodal_seq2seq_gscan_tpu_torch.models.params import ModelParams
from multimodal_seq2seq_gscan_tpu_torch.ops.decode_block import (
    BlockOutput, decode_block_plain, fused_decode_block, pack_decoder_weights)
from multimodal_seq2seq_gscan_tpu_torch.utils.precision import full_float32

DECODE_IMPLS = ("block", "block_plain", "step")
COMPUTE_DTYPES = (None, "float32", "bfloat16", "bfloat16_mixed",
                  "bfloat16_keys")


class GreedyDecodeOutput(NamedTuple):
    """Output of the batched greedy decode, on the decode's device.

    tokens:           [B, S] int32 emitted token ids (0 after done).
    emitted_mask:     [B, S] 1.0 while the example was still emitting.
    lengths:          [B] int32 number of emitted tokens incl. a final EOS.
    attention_commands:   [B, S, M_t] textual attention per emitted step.
    attention_situations: [B, S, M_v] visual attention per emitted step.
    position_accuracy: [B] aux target-position accuracy (0 if aux task off).
    top2_gap:         [B, S] top-2 logit gap per step (``"block_plain"``
                      only, else None; inf in skipped blocks).
    """

    tokens: torch.Tensor
    emitted_mask: torch.Tensor
    lengths: torch.Tensor
    attention_commands: torch.Tensor
    attention_situations: torch.Tensor
    position_accuracy: torch.Tensor
    top2_gap: Optional[torch.Tensor] = None


def make_greedy_decoder(config: ModelConfig, max_decoding_steps: int,
                        exit_check_every: int = 32,
                        decode_impl: str = "block",
                        compute_dtype: Optional[str] = None):
    """Build a batched greedy decoder ``decode(params, input_ids,
    input_lengths, situations, target_positions) -> GreedyDecodeOutput``.

    The inputs' device is the decode's device. ``"block"`` and
    ``"block_plain"`` take the flagship decoder (one layer, conditional
    attention) in float32; for any other decoder or a bf16
    ``compute_dtype`` the decoder warns and runs ``"step"``
    (``models.config.decoder_impl``).
    """
    if decode_impl not in DECODE_IMPLS:
        raise ValueError("decode_impl must be one of {}, got {!r}".format(
            DECODE_IMPLS, decode_impl))
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError("compute_dtype must be one of {}, got {!r}".format(
            COMPUTE_DTYPES, compute_dtype))
    decode_impl = decoder_impl(config, decode_impl, "decode_impl",
                               compute_dtype)
    num_steps = max_decoding_steps + 1  # the reference loops while iter <= max
    block = max(1, min(exit_check_every, num_steps))
    num_blocks = -(-num_steps // block)

    @full_float32()
    def decode(params: ModelParams, input_ids: torch.Tensor,
               input_lengths: torch.Tensor, situations: torch.Tensor,
               target_positions: torch.Tensor) -> GreedyDecodeOutput:
        device = input_ids.device
        vocab = params.encoder.embedding.shape[0]
        if input_ids.numel() and int(input_ids.max()) >= vocab:
            raise ValueError("input token id {} outside the {}-row encoder "
                             "embedding".format(int(input_ids.max()), vocab))
        with torch.no_grad():
            encoded = encode_input(params, config, input_ids, input_lengths,
                                   situations)
            proj_txt, proj_vis = project_keys(params, encoded)
            proj_txt, proj_vis = proj_txt.contiguous(), proj_vis.contiguous()
            cmd_mask = encoded.command_mask.contiguous()
            h, c = initialize_decoder_hidden(params, config, encoded.hidden)
            loop_params = params
            if compute_dtype == "bfloat16_keys":
                proj_txt, proj_vis = (x.to(torch.bfloat16)
                                      for x in (proj_txt, proj_vis))
            elif compute_dtype in ("bfloat16", "bfloat16_mixed"):
                loop_params, proj_txt, proj_vis, cmd_mask, h, c = _to_bf16(
                    (params, proj_txt, proj_vis, cmd_mask, h, c))
                if compute_dtype == "bfloat16_mixed":
                    loop_params = _float32_head(loop_params, params)
            batch = input_ids.shape[0]
            tokens = torch.full((batch,), config.target_sos_idx,
                                dtype=torch.int32, device=device)
            done = torch.zeros((batch,), dtype=torch.bool, device=device)

            blocks: List[BlockOutput] = []
            gaps: List[torch.Tensor] = []
            if decode_impl == "step":
                run = _step_runner(loop_params, config, proj_txt, cmd_mask,
                                   proj_vis)
            else:
                weights = pack_decoder_weights(params, config.target_pad_idx)
                h, c = h[0].contiguous(), c[0].contiguous()
                block_fn = (fused_decode_block if decode_impl == "block"
                            else decode_block_plain)
                extra = {"top2_gap": gaps} if decode_impl == "block_plain" \
                    else {}

                def run(h, c, tokens, done, steps):
                    return block_fn(proj_txt, cmd_mask, proj_vis, h, c,
                                    tokens, done, weights, num_steps=steps,
                                    eos_idx=config.target_eos_idx, **extra)

            for index in range(num_blocks):
                if index and bool(done.all()):
                    break
                # The step path stops at the cap; a block always runs whole
                # and its steps past the cap are cut off below.
                steps = (min(block, num_steps - index * block)
                         if decode_impl == "step" else block)
                out = run(h, c, tokens, done, steps)
                h, c, tokens, done = out.h, out.c, out.tokens, out.done
                blocks.append(out)
            return _assemble(config, blocks, gaps, num_steps, batch,
                             proj_txt.shape[1], proj_vis.shape[1], device,
                             target_positions)

    return decode


def _to_bf16(tree):
    """Every floating tensor of a (nested) tuple of tensors and NamedTuples
    in bf16; other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.to(torch.bfloat16) if tree.is_floating_point() else tree
    if isinstance(tree, tuple):
        items = [_to_bf16(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(
            items)
    return tree


def _float32_head(loop_params: ModelParams, params: ModelParams
                  ) -> ModelParams:
    """``loop_params`` with the output head's two matrices of ``params``
    (float32): the logits and the argmax in float32."""
    return loop_params._replace(decoder=loop_params.decoder._replace(
        output_to_hidden_w=params.decoder.output_to_hidden_w,
        hidden_to_output_w=params.decoder.hidden_to_output_w))


def _step_runner(params, config, proj_txt, cmd_mask, proj_vis):
    """A block of ``steps`` decoder steps through ``decoder_step``."""

    def run(h, c, tokens, done, steps) -> BlockOutput:
        step_tokens, step_emitted, attn_cmds, attn_sits = [], [], [], []
        for _ in range(steps):
            logits, (h_new, c_new), attn_cmd, attn_sit = decoder_step(
                params, config, tokens, (h, c), proj_txt, cmd_mask, proj_vis)
            next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            emitting = ~done
            keep = emitting[None, :, None]
            h = torch.where(keep, h_new, h)
            c = torch.where(keep, c_new, c)
            step_tokens.append(torch.where(emitting, next_tokens,
                                           torch.zeros_like(next_tokens)))
            step_emitted.append(emitting.float())
            tokens = torch.where(emitting, next_tokens, tokens)
            done = done | (next_tokens == config.target_eos_idx)
            attn_cmds.append(attn_cmd)
            attn_sits.append(attn_sit)
        return BlockOutput(h, c, tokens, done, torch.stack(step_tokens),
                           torch.stack(step_emitted), torch.stack(attn_cmds),
                           torch.stack(attn_sits))

    return run


def _assemble(config, blocks, gaps, num_steps, batch, m_t, m_v, device,
              target_positions) -> GreedyDecodeOutput:
    """Concatenate the blocks, zero-fill skipped ones, cut to ``num_steps``."""

    def stacked(field, shape_tail, dtype):
        parts = [getattr(b, field) for b in blocks]
        run_steps = sum(p.shape[0] for p in parts)
        if run_steps < num_steps:
            parts.append(torch.zeros((num_steps - run_steps, batch)
                                     + shape_tail, dtype=dtype,
                                     device=device))
        return torch.cat(parts)[:num_steps].transpose(0, 1).contiguous()

    tokens = stacked("step_tokens", (), torch.int32)
    emitted = stacked("step_emitted", (), torch.float32)
    attn_cmd = stacked("step_attn_cmd", (m_t,), torch.float32)
    attn_sit = stacked("step_attn_sit", (m_v,), torch.float32)
    lengths = emitted.sum(dim=1).to(torch.int32)
    top2_gap = None
    if gaps:
        top2_gap = torch.full((num_steps, batch), float("inf"),
                              device=device)
        run = torch.stack(gaps)[:num_steps]
        top2_gap[:run.shape[0]] = run
        top2_gap = top2_gap.transpose(0, 1).contiguous()

    if config.auxiliary_task:
        # Aux accuracy from visual attention summed over emitted steps
        # (reference predict.py:118-120 sums the contexts over time).
        summed = torch.sum(attn_sit * emitted[..., None], dim=1)
        predictions = torch.argmax(auxiliary_task_forward(summed), dim=-1)
        position_accuracy = 100.0 * (
            predictions == target_positions.to(device)).float()
    else:
        position_accuracy = torch.zeros((batch,), device=device)
    return GreedyDecodeOutput(
        tokens=tokens, emitted_mask=emitted, lengths=lengths,
        attention_commands=attn_cmd, attention_situations=attn_sit,
        position_accuracy=position_accuracy, top2_gap=top2_gap)


def strip_output_sequences(output: GreedyDecodeOutput, eos_idx: int
                           ) -> Tuple[List[List[int]], List[int]]:
    """Host-side: per-example token lists with any trailing EOS stripped.

    Returns (sequences, kept_lengths) where kept_lengths[i] is the number of
    steps whose attention weights the reference keeps (popped along with the
    EOS token, reference predict.py:114-117).
    """
    tokens = output.tokens.cpu().numpy()
    lengths = output.lengths.cpu().numpy()
    sequences = []
    kept_lengths = []
    for i in range(tokens.shape[0]):
        n = int(lengths[i])
        seq = tokens[i, :n].tolist()
        if n > 0 and seq[-1] == eos_idx:
            seq = seq[:-1]
            n -= 1
        sequences.append(seq)
        kept_lengths.append(n)
    return sequences, kept_lengths
