"""Training state: parameters, Adam with optax's semantics, the lr schedule.

The port of the JAX package's ``train/state.py``: Adam(lr, betas) with the
learning rate ``lr * lr_decay ** (count / lr_decay_steps)`` (reference
seq2seq/train.py:68-70). The arithmetic follows ``optax.adam`` with a
schedule, in float32:
- mu and nu are updated first (``(1 - b) * g^k + b * t``);
- bias correction divides by ``1 - b ** (count + 1)``;
- the step is ``mu_hat / (sqrt(nu_hat) + eps)`` (eps outside the sqrt);
- it is scaled by ``-lr(schedule_count)``, the schedule's count taken
  *before* its increment (optax's ``scale_by_schedule``, ``opt_state/1``).
The update's three count-dependent scalars (the two bias corrections and
the step size) are computed on the host in float32 (``Adam.scalars``) and
enter the arithmetic as 0-d tensors on the parameters' device, so a CUDA
graph of the step reads them from a buffer the host fills before each
replay and does the same arithmetic as an eager step.
"""

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.params import (
    ModelParams, init_model_params, params_from_numpy, tree_map)


class AdamState(NamedTuple):
    """optax's ``(ScaleByAdamState, ScaleByScheduleState)`` for one model."""

    count: int            # opt_state/0/count: Adam updates taken
    mu: ModelParams       # opt_state/0/mu
    nu: ModelParams       # opt_state/0/nu
    schedule_count: int   # opt_state/1/count: the lr schedule's step


class TrainState(NamedTuple):
    step: int
    params: ModelParams
    opt_state: AdamState
    # The JAX state's PRNG key (uint32[2]); with ``step`` it seeds each
    # step's dropout generator (``train/step.py``), so the key round-trips
    # through checkpoints.
    rng: np.ndarray


def make_lr_schedule(learning_rate: float, lr_decay: float,
                     lr_decay_steps: float):
    """``count -> lr * lr_decay ** (count / lr_decay_steps)`` in float32."""
    def schedule(count: int) -> np.float32:
        exponent = np.float32(count) / np.float32(lr_decay_steps)
        return np.float32(learning_rate) * np.power(np.float32(lr_decay),
                                                    exponent)
    return schedule


class Adam(NamedTuple):
    """Adam with an exponentially decaying learning rate (``make_optimizer``
    of the JAX package)."""

    learning_rate: float = 0.001
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    lr_decay: float = 0.9
    lr_decay_steps: float = 20000.0

    def schedule(self, count: int) -> np.float32:
        return make_lr_schedule(self.learning_rate, self.lr_decay,
                                self.lr_decay_steps)(count)

    def init(self, params: ModelParams) -> AdamState:
        zeros = tree_map(torch.zeros_like, params)
        return AdamState(0, zeros, tree_map(torch.zeros_like, params), 0)

    def scalars(self, count: int, schedule_count: int
                ) -> Tuple[float, float, float]:
        """(1 - b1^(count + 1), 1 - b2^(count + 1), -lr(schedule_count)) in
        float32: the scalars of the update from a state at these counts."""
        count = np.float32(count + 1)
        return (float(np.float32(1) - np.power(np.float32(self.b1), count)),
                float(np.float32(1) - np.power(np.float32(self.b2), count)),
                -float(self.schedule(schedule_count)))

    @torch.no_grad()
    def apply(self, params: ModelParams, grads: ModelParams,
              state: AdamState, scalars: Optional[torch.Tensor] = None):
        """One update: (new params, new state). Nothing is modified in
        place. ``scalars``: ``Adam.scalars`` of ``state`` as a float32
        ``[3]`` tensor on the parameters' device (made here if not
        given)."""
        if scalars is None:
            device = params.enc_to_dec_w.device
            scalars = [torch.full((), value, dtype=torch.float32,
                                  device=device)
                       for value in self.scalars(state.count,
                                                 state.schedule_count)]
        bias1, bias2, step_size = scalars[0], scalars[1], scalars[2]
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                      state.nu)

        def update(p, m, v):
            return p + (m / bias1) / (torch.sqrt(v / bias2) + self.eps) \
                * step_size

        new_params = tree_map(update, params, mu, nu)
        return new_params, AdamState(state.count + 1, mu, nu,
                                     state.schedule_count + 1)


def create_train_state(seed: int, config: ModelConfig, optimizer: Adam,
                       device: Union[str, torch.device] = "cuda"
                       ) -> TrainState:
    """Fresh parameters from ``seed`` (a CPU torch.Generator; the bits differ
    from JAX's) and a zero Adam state. The key is ``[0, seed]``, the layout
    of ``jax.random.PRNGKey(seed)``."""
    params = init_model_params(config,
                               torch.Generator().manual_seed(seed), device)
    return TrainState(step=0, params=params, opt_state=optimizer.init(params),
                      rng=np.array([0, seed], np.uint32))


def train_state_from_numpy(tree: dict,
                           device: Union[str, torch.device] = "cuda"
                           ) -> TrainState:
    """A TrainState from the JAX checkpoint's map (``step``, ``params``,
    ``opt_state/0/{count,mu,nu}``, ``opt_state/1/count``, ``rng``), beside
    ``params_from_numpy``."""
    adam, schedule = tree["opt_state"]["0"], tree["opt_state"]["1"]
    return TrainState(
        step=int(tree["step"]),
        params=params_from_numpy(tree["params"], device),
        opt_state=AdamState(count=int(adam["count"]),
                            mu=params_from_numpy(adam["mu"], device),
                            nu=params_from_numpy(adam["nu"], device),
                            schedule_count=int(schedule["count"])),
        rng=np.asarray(tree["rng"], np.uint32))
