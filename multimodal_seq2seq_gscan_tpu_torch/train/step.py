"""The training step: loss (+ weighted aux loss), gradients, Adam update.

The port of the JAX package's ``train/step.py`` (``loss_fn``,
``train_step_body``, ``make_eval_forward``), eager, on one device or on
one rank of a data-parallel mesh (``parallel/mesh.py``). Each
step's dropout draws from a ``torch.Generator`` on the batch's device seeded
from (the state's key, the step), in the role of
``jax.random.fold_in(state.rng, state.step)``: a resumed run draws the same
masks as an unbroken one. A caller may pass the step's generator (seeded
so) and Adam's scalars itself: the resident trainer's CUDA graph of the
step (``train/resident.py``) reuses generators and a scalar buffer across
replays.

Under a mesh the step is the global batch's, as JAX's ``P('data')`` step
is, and not a mean of per-rank means: the token and row counts that
normalise the two losses are summed over the ranks first, each rank
differentiates its sum over those global counts, and the gradients, the
loss terms and the metrics' counts are summed in one all-reduce, so ranks
with different token counts (bucketed gSCAN batches always have them)
give the global step; every rank then takes the same Adam update. At one
rank this is the unsharded step's arithmetic, bit for bit. Dropout draws
the global batch's masks and keeps the rank's rows (``models.nn.RowShard``).
The kernels stay: JAX falls back to XLA under a mesh because XLA cannot
partition a Pallas call, but a rank here is a whole process on its
device, and kernels 3, 4 and the helper take any batch, so they run on
every rank's rows.
"""

import hashlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from multimodal_seq2seq_gscan_tpu_torch.core.batch import Batch
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.model import (
    auxiliary_counts, forward, get_auxiliary_loss, get_loss, get_metrics,
    metric_counts, metrics_from_counts, remove_start_of_sequence)
from multimodal_seq2seq_gscan_tpu_torch.models.nn import RowShard
from multimodal_seq2seq_gscan_tpu_torch.models.params import (
    ModelParams, leaves, tree_unflatten)
from multimodal_seq2seq_gscan_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_sum)
from multimodal_seq2seq_gscan_tpu_torch.train.state import Adam, TrainState
from multimodal_seq2seq_gscan_tpu_torch.utils.precision import (
    deterministic_convolutions, full_float32)
from multimodal_seq2seq_gscan_tpu_torch.utils.profiling import span


def step_seed(rng: np.ndarray, step: int) -> int:
    """A 63-bit generator seed from the state's key and the step."""
    digest = hashlib.sha256(np.asarray(rng, np.uint32).tobytes()
                            + int(step).to_bytes(8, "little")).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def step_generator(state: TrainState, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        step_seed(state.rng, state.step))


def loss_fn(params: ModelParams, config: ModelConfig, batch: Batch,
            generator, weight_target_loss: float,
            deterministic: bool = False,
            totals: Optional[torch.Tensor] = None):
    """(loss, (log_probs, aux_scores)); the aux loss is added with weight
    ``weight_target_loss`` when ``config.auxiliary_task``. ``totals``
    (``batch_totals``) normalise the two sums, by default by the batch's
    own counts."""
    log_probs, aux_scores = forward(
        params, config, batch.input_ids, batch.input_lengths,
        batch.situations, batch.target_ids, generator=generator,
        deterministic=deterministic)
    loss = get_loss(config, log_probs, batch.target_ids,
                    None if totals is None else totals[0])
    if config.auxiliary_task:
        aux_loss = get_auxiliary_loss(
            aux_scores, batch.target_positions,
            valid=batch.target_lengths > 0,
            total=None if totals is None else totals[1])
        loss = loss + weight_target_loss * aux_loss
    return loss, (log_probs, aux_scores)


def batch_totals(config: ModelConfig, batch: Batch,
                 mesh: Optional[Mesh]) -> torch.Tensor:
    """The global batch's two loss normalisers, ``[non-pad target tokens,
    rows with a target]`` (each at least 1), float32, summed over the
    mesh's data ranks."""
    tokens = (remove_start_of_sequence(batch.target_ids)
              != config.target_pad_idx).sum()
    counts = torch.stack([tokens, (batch.target_lengths > 0).sum()]).float()
    return torch.clamp(all_reduce_sum(mesh, counts), min=1.0)


def _rank_loss_and_grads(state: TrainState, batch: Batch,
                         config: ModelConfig, weight_target_loss: float,
                         generator, mesh: Optional[Mesh]):
    """The rank's loss term, outputs and gradients as a list, and the
    global normalisers (None without a mesh). Under a mesh, the loss is
    the rank's sum over the global counts and dropout draws the global
    batch's masks (``RowShard``), so the ranks' terms add up to the
    global batch's loss and gradients."""
    if generator is None:
        generator = step_generator(state, batch.target_ids.device)
    totals = None
    if mesh is not None:
        totals = batch_totals(config, batch, mesh)
        rows = batch.target_ids.shape[0]
        generator = RowShard(generator, rows * mesh.data_parallel,
                             rows * mesh.data_index)
    params = tree_unflatten(state.params, [
        p.detach().requires_grad_(True) for p in leaves(state.params)])
    with torch.enable_grad():
        loss, outputs = loss_fn(params, config, batch, generator,
                                weight_target_loss, totals=totals)
        grads = torch.autograd.grad(loss, leaves(params))
    return (loss.detach(), tuple(o.detach() for o in outputs), list(grads),
            params, totals)


def _sum_over_ranks(mesh: Optional[Mesh], grads, extra: torch.Tensor):
    """Gradients and a vector of per-rank terms summed over the data
    ranks in one all-reduce: (grads, extra)."""
    if mesh is None:
        return grads, extra
    flat = all_reduce_sum(mesh, torch.cat(
        [g.reshape(-1) for g in grads] + [extra]))
    summed, offset = [], 0
    for g in grads:
        summed.append(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return summed, flat[offset:]


@full_float32()
@deterministic_convolutions()
def loss_and_grads(state: TrainState, batch: Batch, config: ModelConfig,
                   weight_target_loss: float = 0.3,
                   generator: Optional[torch.Generator] = None,
                   mesh: Optional[Mesh] = None):
    """The step's loss, its (log_probs, aux_scores) and the gradients of
    every parameter, as a ModelParams tree; dropout from ``generator``, by
    default the step's (``step_generator``). cuDNN runs its deterministic
    algorithms here (``utils/precision.py``): the same state and batch
    give the same bits. Under a ``mesh`` the batch is the rank's rows, and
    the loss and gradients are the global batch's (the outputs the
    rank's)."""
    loss, outputs, grads, params, _ = _rank_loss_and_grads(
        state, batch, config, weight_target_loss, generator, mesh)
    grads, loss = _sum_over_ranks(mesh, grads, loss.reshape(1))
    return loss.reshape(()), outputs, tree_unflatten(params, grads)


@full_float32()
@deterministic_convolutions()
def train_step(state: TrainState, batch: Batch, config: ModelConfig,
               optimizer: Adam, weight_target_loss: float = 0.3,
               generator: Optional[torch.Generator] = None,
               adam_scalars: Optional[torch.Tensor] = None,
               mesh: Optional[Mesh] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step: (new state, metrics as 0-d tensors on the
    batch's device: loss, accuracy, exact_match, aux_accuracy).
    ``generator`` and ``adam_scalars`` default to the step's own (see
    ``loss_and_grads`` and ``Adam.apply``). Under a ``mesh`` the batch is
    the rank's rows of the global batch, and the step is the global
    batch's: loss normalisers, gradients and metrics are global sums (two
    all-reduces, the normalisers before the forward and the rest after
    the backward), and every rank takes the same Adam update."""
    loss, (log_probs, aux_scores), grads, params, totals = \
        _rank_loss_and_grads(state, batch, config, weight_target_loss,
                             generator, mesh)
    with torch.no_grad():
        counts = metric_counts(config, log_probs, batch.target_ids)
        if config.auxiliary_task:
            aux_counts = auxiliary_counts(aux_scores, batch.target_positions,
                                          batch.target_lengths > 0)
        else:
            aux_counts = torch.zeros(2, device=loss.device)
        if mesh is not None:
            grads, summed = _sum_over_ranks(mesh, grads, torch.cat(
                [loss.reshape(1), counts.float(), aux_counts[:1]]))
            loss, counts = summed[0], summed[1:5]
            aux_counts = torch.stack([summed[5], totals[1]])
        accuracy, exact_match = metrics_from_counts(counts)
        aux_accuracy = (100.0 * aux_counts[0]
                        / torch.clamp(aux_counts[1], min=1.0)
                        if config.auxiliary_task
                        else torch.zeros((), device=loss.device))
    with span("gscan.step.optimizer", timed=True):
        new_params, new_opt_state = optimizer.apply(
            state.params, tree_unflatten(params, grads), state.opt_state,
            adam_scalars)
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
