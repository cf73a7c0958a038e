"""The reference's training steps: the loss's gradients by autograd and
Adam with the exponentially decaying learning rate.

Adam follows optax's ``adam`` under a schedule (the reference code's
``torch.optim.Adam`` with ``lr * lr_decay ** (step / lr_decay_steps)``):
mu and nu updated first, bias corrections ``1 - b ** (count + 1)``, the
step ``mu_hat / (sqrt(nu_hat) + eps)`` scaled by ``-lr(count)``. optax
computes the bias corrections and the learning rate in float32, and so
does this (``1 - 0.999`` in float32 is 1.3e-5 off the real number, which
moves every update by 6e-6 of itself).

``step_seed`` is a frozen copy of the port's rule
(``train/step.py::step_seed`` at commit cacbdcd) that turns the training
state's key and the step into the seed of that step's dropout generator;
the reference draws its own masks from it.

Imports torch, numpy and the standard library, and the reference's model:
nothing of the program, of the JAX package or of the benchmark's harness.
"""

import hashlib
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from benchmark.reference.model import Arithmetic, training_loss

EPS = 1e-8


def step_seed(key: np.ndarray, step: int) -> int:
    """A 63-bit generator seed from the state's key and the step."""
    digest = hashlib.sha256(np.asarray(key, np.uint32).tobytes()
                            + int(step).to_bytes(8, "little")).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class Followed(NamedTuple):
    losses: List[float]                     # each step's loss
    first_grads: Dict[str, torch.Tensor]    # step 1's gradients
    params: Dict[str, torch.Tensor]         # after the last step


def follow(W0: Dict[str, torch.Tensor], cfg: dict, batches, key: np.ndarray,
           arithmetic: Arithmetic) -> Followed:
    """Train from ``W0`` over ``batches`` (one tuple of device tensors a
    step: input ids, lengths, situations, target ids), step s drawing its
    dropout from ``step_seed(key, s)``, as the program's first steps do."""
    names = list(W0)
    params = {n: W0[n].detach().clone() for n in names}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2 = cfg["adam_beta_1"], cfg["adam_beta_2"]
    losses, first = [], None
    for count, batch in enumerate(batches):
        device = batch[0].device
        generator = torch.Generator(device=device).manual_seed(
            step_seed(key, count))
        leaves = {n: params[n].requires_grad_(True) for n in names}
        loss = training_loss(arithmetic, leaves, cfg, batch, generator)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: g.detach().clone() for n, g in zip(names, grads)}
        lr, bias1, bias2 = adam_scalars(cfg, count)
        with torch.no_grad():
            for n, g in zip(names, grads):
                mu[n] = (1 - b1) * g + b1 * mu[n]
                nu[n] = (1 - b2) * (g * g) + b2 * nu[n]
                params[n] = (params[n].detach()
                             - lr * (mu[n] / bias1)
                             / (torch.sqrt(nu[n] / bias2) + EPS))
    return Followed(losses, first, {n: p.detach() for n, p in params.items()})


def adam_scalars(cfg: dict, count: int):
    """(learning rate, 1 - b1 ** (count + 1), 1 - b2 ** (count + 1)) of
    the update from a state at ``count``, in float32 as optax has them."""
    f = np.float32
    lr = f(cfg["learning_rate"]) * np.power(
        f(cfg["lr_decay"]), f(count) / f(cfg["lr_decay_steps"]))
    steps = f(count + 1)
    return (float(lr), float(f(1) - np.power(f(cfg["adam_beta_1"]), steps)),
            float(f(1) - np.power(f(cfg["adam_beta_2"]), steps)))
