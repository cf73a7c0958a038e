"""The reference's reading of a greedy decode: the served tokens replayed
through the plain model, step by step.

For each row the decode served, the replay feeds SOS and then the served
tokens, and at every step yields the logits and both attention rows that
the plain model gives for that history. A row stops emitting after its
first EOS (or at the step cap); from then on its state is frozen, so its
attention rows are those of the frozen state, in every step of a block the
decode ran, and zero in the blocks it skipped (the early exit checks after
every block whether all rows of the batch are done).

Imports torch and the reference's model alone.
"""

from typing import Dict, NamedTuple

import torch

from benchmark.reference.model import (EOS, SOS, Arithmetic, decoder_step,
                                       encode)


class Replay(NamedTuple):
    logits: torch.Tensor     # [R, S, V]
    attn_cmd: torch.Tensor   # [R, S, M_t], zero past the steps run
    attn_sit: torch.Tensor   # [R, S, M_v]
    lengths: torch.Tensor    # [R] steps emitted: through the first EOS


def served_lengths(tokens: torch.Tensor) -> torch.Tensor:
    """Steps a greedy decode emits for these served tokens: through the
    first EOS, or all of them."""
    steps = tokens.shape[1]
    is_eos = tokens == EOS
    first = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1),
                        torch.full_like(tokens[:, 0], steps - 1).long())
    return (first + 1).long()


@torch.no_grad()
def replay(arithmetic: Arithmetic, W: Dict[str, torch.Tensor], cfg: dict,
           input_ids, input_lengths, situations, tokens: torch.Tensor,
           steps_run: torch.Tensor) -> Replay:
    """Replay ``tokens`` ([R, S] served ids) for rows whose batches ran
    ``steps_run`` ([R]) decoder steps."""
    enc = encode(arithmetic, W, cfg, input_ids, input_lengths, situations)
    rows, steps = tokens.shape
    lengths = served_lengths(tokens)
    h, c = enc.h0, enc.h0
    previous = torch.full((rows,), SOS, dtype=torch.long,
                          device=tokens.device)
    logits, attn_cmd, attn_sit = [], [], []
    for t in range(steps):
        step = decoder_step(arithmetic, W, enc, previous, h, c)
        logits.append(step.logits)
        ran = (t < steps_run)[:, None].float()
        attn_cmd.append(step.attn_cmd * ran)
        attn_sit.append(step.attn_sit * ran)
        emitting = (t < lengths)[:, None]
        h = torch.where(emitting, step.h, h)
        c = torch.where(emitting, step.c, c)
        previous = torch.where(t < lengths, tokens[:, t].long(), previous)
    return Replay(torch.stack(logits, 1), torch.stack(attn_cmd, 1),
                  torch.stack(attn_sit, 1), lengths)
