"""The numbers that decide ``correct``, each against its limit.

Training: the first steps' losses, the first gradient as Adam got it and
the parameters' change after the steps, against the reference that
follows them. Norms are taken per leaf and compared by the worst leaf:
the gap between the program's norm and the reference's, over the larger
of the reference's norm of that leaf and the median leaf's. Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out (Adam moves them by round-off alone).

Decode: the served tokens replayed through the reference: the widest gap
by which a served token's logit lies below the reference's best, the
largest difference of an attention weight (both stacks, every step of the
decode's output), and a count of rows whose emitted mask, length or
tokens after the end break the early exit's rules (exact: limit 0).
"""

import math
import statistics
from typing import Dict, List, NamedTuple

import torch


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def passed(self) -> bool:
        return self.value <= self.limit and not math.isnan(self.value)


def judged(values: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    missing = sorted(set(values) - set(limits))
    if missing:
        raise ValueError("no limit for {}".format(missing))
    return [Check(name, float(values[name]), float(limits[name]))
            for name in values]


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: math.sqrt(float((t.double() ** 2).sum()))
            for n, t in tree.items()}


def counted_leaves(reference_grads: Dict[str, torch.Tensor]) -> List[str]:
    norms = _norms(reference_grads)
    median = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= 1e-3 * median]


def norm_gap(program: Dict[str, torch.Tensor],
             reference: Dict[str, torch.Tensor], leaves: List[str]) -> float:
    p, r = _norms({n: program[n] for n in leaves}), _norms(
        {n: reference[n] for n in leaves})
    median = statistics.median(r.values())
    return max(abs(p[n] - r[n]) / max(r[n], median) for n in leaves)


def training_numbers(program_losses, reference_losses, program_grads,
                     reference_grads, program_change,
                     reference_change) -> Dict[str, float]:
    leaves = counted_leaves(reference_grads)
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in
                        zip(program_losses, reference_losses)),
        "grad_gap": norm_gap(program_grads, reference_grads, leaves),
        "update_gap": norm_gap(program_change, reference_change, leaves),
    }


def token_gap(reference_logits: torch.Tensor, tokens: torch.Tensor,
              lengths: torch.Tensor) -> float:
    """The widest gap of a served token's logit below the reference's
    best, over the steps each row emitted."""
    best = reference_logits.max(dim=-1).values
    served = torch.gather(reference_logits, -1,
                          tokens.long().clamp(min=0)[..., None])[..., 0]
    steps = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    emitted = steps < lengths[:, None]
    return float(torch.where(emitted, best - served,
                             torch.zeros_like(best)).max())


def attention_gap(program_cmd, program_sit, reference_cmd,
                  reference_sit) -> float:
    return max(float((program_cmd - reference_cmd).abs().max()),
               float((program_sit - reference_sit).abs().max()))


def exit_faults(tokens, emitted, lengths, reference_lengths) -> int:
    """Rows whose length, emitted mask or tokens past the end depart from
    what their served tokens make them (emitting through the first EOS)."""
    steps = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    expected = steps < reference_lengths[:, None]
    bad = ((lengths.long() != reference_lengths)
           | (emitted.bool() != expected).any(dim=1)
           | ((tokens != 0) & ~expected).any(dim=1))
    return int(bad.sum())
