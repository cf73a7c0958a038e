"""The training step: loss (+ weighted aux loss), gradients, Adam update.

The port of the JAX package's ``train/step.py`` (``loss_fn``,
``train_step_body``, ``make_eval_forward``), eager and on one device. Each
step's dropout draws from a ``torch.Generator`` on the batch's device seeded
from (the state's key, the step), in the role of
``jax.random.fold_in(state.rng, state.step)``: a resumed run draws the same
masks as an unbroken one. A caller may pass the step's generator (seeded
so) and Adam's scalars itself: the resident trainer's CUDA graph of the
step (``train/resident.py``) reuses generators and a scalar buffer across
replays.
"""

import hashlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from multimodal_seq2seq_gscan_tpu_torch.core.batch import Batch
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.model import (
    forward, get_auxiliary_accuracy, get_auxiliary_loss, get_loss,
    get_metrics)
from multimodal_seq2seq_gscan_tpu_torch.models.params import (
    ModelParams, leaves, tree_unflatten)
from multimodal_seq2seq_gscan_tpu_torch.train.state import Adam, TrainState
from multimodal_seq2seq_gscan_tpu_torch.utils.precision import full_float32


def step_seed(rng: np.ndarray, step: int) -> int:
    """A 63-bit generator seed from the state's key and the step."""
    digest = hashlib.sha256(np.asarray(rng, np.uint32).tobytes()
                            + int(step).to_bytes(8, "little")).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def step_generator(state: TrainState, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        step_seed(state.rng, state.step))


def loss_fn(params: ModelParams, config: ModelConfig, batch: Batch,
            generator: torch.Generator, weight_target_loss: float,
            deterministic: bool = False):
    """(loss, (log_probs, aux_scores)); the aux loss is added with weight
    ``weight_target_loss`` when ``config.auxiliary_task``."""
    log_probs, aux_scores = forward(
        params, config, batch.input_ids, batch.input_lengths,
        batch.situations, batch.target_ids, generator=generator,
        deterministic=deterministic)
    loss = get_loss(config, log_probs, batch.target_ids)
    if config.auxiliary_task:
        aux_loss = get_auxiliary_loss(aux_scores, batch.target_positions,
                                      valid=batch.target_lengths > 0)
        loss = loss + weight_target_loss * aux_loss
    return loss, (log_probs, aux_scores)


@full_float32()
def loss_and_grads(state: TrainState, batch: Batch, config: ModelConfig,
                   weight_target_loss: float = 0.3,
                   generator: Optional[torch.Generator] = None):
    """The step's loss, its (log_probs, aux_scores) and the gradients of
    every parameter, as a ModelParams tree; dropout from ``generator``, by
    default the step's (``step_generator``)."""
    if generator is None:
        generator = step_generator(state, batch.target_ids.device)
    params = tree_unflatten(state.params, [
        p.detach().requires_grad_(True) for p in leaves(state.params)])
    with torch.enable_grad():
        loss, outputs = loss_fn(params, config, batch, generator,
                                weight_target_loss)
        grads = torch.autograd.grad(loss, leaves(params))
    return (loss.detach(), tuple(o.detach() for o in outputs),
            tree_unflatten(params, list(grads)))


def train_step(state: TrainState, batch: Batch, config: ModelConfig,
               optimizer: Adam, weight_target_loss: float = 0.3,
               generator: Optional[torch.Generator] = None,
               adam_scalars: Optional[torch.Tensor] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step: (new state, metrics as 0-d tensors on the
    batch's device: loss, accuracy, exact_match, aux_accuracy).
    ``generator`` and ``adam_scalars`` default to the step's own (see
    ``loss_and_grads`` and ``Adam.apply``)."""
    loss, (log_probs, aux_scores), grads = loss_and_grads(
        state, batch, config, weight_target_loss, generator)
    new_params, new_opt_state = optimizer.apply(state.params, grads,
                                                state.opt_state,
                                                adam_scalars)
    with torch.no_grad():
        accuracy, exact_match = get_metrics(config, log_probs,
                                            batch.target_ids)
        if config.auxiliary_task:
            aux_accuracy = get_auxiliary_accuracy(
                aux_scores, batch.target_positions,
                valid=batch.target_lengths > 0)
        else:
            aux_accuracy = torch.zeros((), device=loss.device)
    metrics = {"loss": loss, "accuracy": accuracy,
               "exact_match": exact_match, "aux_accuracy": aux_accuracy}
    return TrainState(step=state.step + 1, params=new_params,
                      opt_state=new_opt_state, rng=state.rng), metrics


def make_eval_forward(config: ModelConfig):
    """Teacher-forced eval forward (loss and metrics, no dropout)."""

    @torch.no_grad()
    @full_float32()
    def eval_forward(params: ModelParams, batch: Batch):
        log_probs, _ = forward(params, config, batch.input_ids,
                               batch.input_lengths, batch.situations,
                               batch.target_ids, deterministic=True)
        loss = get_loss(config, log_probs, batch.target_ids)
        accuracy, exact_match = get_metrics(config, log_probs,
                                            batch.target_ids)
        return {"loss": loss, "accuracy": accuracy,
                "exact_match": exact_match}

    return eval_forward
