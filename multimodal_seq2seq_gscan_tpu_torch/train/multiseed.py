"""Multi-seed campaigns: every seed of one configuration trained at once.

The port of the JAX package's ``train/multiseed.py``. JAX stacks the seeds'
states on a leading axis and vmaps the resident chunk over it. The port
cannot vmap: kernels 3 and 4 run in a ``torch.autograd.Function`` over
ctypes calls, which has no vmap rule. It captures instead one CUDA graph
that runs each seed's K steps in turn (``train/resident.py``'s
``ChunkGraphs`` with one row of the flat state buffer per seed), so that
seed s does exactly the arithmetic of its own single-seed chunk:

- the seeds' params, mu and nu are stacked as the rows of one ``[S, F]``
  buffer (``stack_train_states``; ``slice_train_state`` gives a seed's
  state as views of its row, without a copy);
- each seed keeps its own data order, the index stream of
  ``np.random.default_rng(seed)`` a single-seed run draws, and its own
  dropout (``step_seed(key_s, step)``); the resident data is stored once
  for all seeds;
- each evaluation decodes every seed's dev subset (the first
  ``max_testing_examples`` of ``default_rng(seed).permutation``, as the
  single-seed ``train`` scores), then writes every seed's checkpoint into
  ``<output_directory>/seed_<s>/``, the files a single-seed run writes.

The gain is operational: one launch, one resident dataset, one log. A
single-seed step is already device-bound, so the one graph is not faster
than the seeds' graphs replayed in turn (``PERF.md``).

Three faults of the JAX campaign are not copied: ``resume_from_file``
must name the campaign's output directory (JAX takes it as a switch); the
checkpoints of an evaluation are written under temporary names after
every seed's decode and then renamed, each seed's sidecar last, and a
resume completes renames that a kill interrupted (JAX writes each seed in
place between decodes, so a kill leaves seeds at different iterations);
and ``campaign.json`` records the seeds, batch size, chunk size and layout,
which a resume must repeat (JAX checks only the chunk grid).
"""

import json
import logging
import os
import shutil
import time
from typing import (Callable, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from multimodal_seq2seq_gscan_tpu_torch.decode.predict import evaluate
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.params import ModelParams
from multimodal_seq2seq_gscan_tpu_torch.train import checkpoint as ckpt
from multimodal_seq2seq_gscan_tpu_torch.train.resident import (
    METRIC_NAMES, ChunkGraphs, ResidentData, build_resident_data,
    eager_chunk, flatten_state, gather_batch, host_resident_data,
    index_block_stream, resolve_chunk_size, row_trees, state_row_floats,
    stratified_index_block_stream)
from multimodal_seq2seq_gscan_tpu_torch.train.state import (
    Adam, AdamState, TrainState, create_train_state)
from multimodal_seq2seq_gscan_tpu_torch.train.step import train_step
from multimodal_seq2seq_gscan_tpu_torch.utils.profiling import StepProfiler

logger = logging.getLogger(__name__)

CAMPAIGN_FILE = "campaign.json"
# The suffix of a checkpoint file written but not yet renamed.
PENDING = ".pending"


class StackedTrainState(NamedTuple):
    """S seeds' TrainStates: seed s's params, mu and nu in row s of
    ``flat`` (``[S, state_row_floats]``, ``train/resident.py``'s layout),
    its counts and key at index s."""

    flat: torch.Tensor
    template: ModelParams   # any seed's params: the rows' layout
    step: Tuple[int, ...]
    count: Tuple[int, ...]
    schedule_count: Tuple[int, ...]
    rng: np.ndarray         # [S, 2] uint32


def stack_train_states(states: Sequence[TrainState]) -> StackedTrainState:
    """The seeds' states as the rows of one new buffer."""
    template = states[0].params
    flat = torch.zeros((len(states), state_row_floats(template)),
                       dtype=torch.float32,
                       device=template.enc_to_dec_w.device)
    for row, state in zip(flat, states):
        flatten_state(state, row)
    return StackedTrainState(
        flat, template, tuple(int(s.step) for s in states),
        tuple(int(s.opt_state.count) for s in states),
        tuple(int(s.opt_state.schedule_count) for s in states),
        np.stack([np.asarray(s.rng, np.uint32) for s in states]))


def slice_train_state(stacked: StackedTrainState, i: int) -> TrainState:
    """Seed ``i``'s state as views of its row (no copy)."""
    params, mu, nu = row_trees(stacked.flat[i], stacked.template)
    return TrainState(step=stacked.step[i], params=params,
                      opt_state=AdamState(stacked.count[i], mu, nu,
                                          stacked.schedule_count[i]),
                      rng=stacked.rng[i])


def make_multiseed_train_chunk(config: ModelConfig, optimizer: Adam,
                               weight_target_loss: float = 0.3):
    """``chunk(stacked_state, data, idx_blocks, segments=None) ->
    (stacked_state, metrics)``: each seed's K steps on its ``[K, B]`` block
    of ``idx_blocks`` (``[S, K, B]``), the metrics dict of ``[S, K]``
    tensors. The resident ``data`` and ``segments`` are shared by the
    seeds. On the card one CUDA graph runs every seed's steps, one seed
    after another; on the CPU each seed runs its eager chunk. The state
    passed in is not modified."""
    graphs = ChunkGraphs(config, optimizer, weight_target_loss)

    def chunk(stacked: StackedTrainState, data: ResidentData, idx_blocks,
              segments=None):
        idx_blocks = np.asarray(idx_blocks)
        steps = idx_blocks.shape[1]
        states = [slice_train_state(stacked, i)
                  for i in range(idx_blocks.shape[0])]
        if data.input_ids.device.type != "cuda":
            results = [eager_chunk(state, data, block, segments, config,
                                   optimizer, weight_target_loss)
                       for state, block in zip(states, idx_blocks)]
            return (stack_train_states([state for state, _ in results]),
                    {name: torch.stack([m[name] for _, m in results])
                     for name in METRIC_NAMES})
        flat, metrics = graphs.replay(states, data, idx_blocks, segments)
        moved = tuple(x + steps for x in stacked.step)
        return (stacked._replace(
            flat=flat, step=moved,
            count=tuple(x + steps for x in stacked.count),
            schedule_count=tuple(x + steps for x in stacked.schedule_count)),
            dict(zip(METRIC_NAMES, metrics.permute(2, 0, 1))))

    return chunk


def _pending_files(seed_dir: str) -> List[Tuple[str, str]]:
    """(pending, final) paths of an evaluation's files for one seed, the
    checkpoint's sidecar, which names the iteration, last."""
    return [(os.path.join(seed_dir, name + PENDING + suffix),
             os.path.join(seed_dir, name + suffix))
            for name in (ckpt.BEST_CHECKPOINT_FILE, ckpt.CHECKPOINT_FILE)
            for suffix in ("", ".json")]


def _commit(seed_dir: str):
    for pending, final in _pending_files(seed_dir):
        if os.path.exists(pending):
            os.replace(pending, final)


def _iteration(meta_path: str) -> Optional[int]:
    if not os.path.isfile(meta_path):
        return None
    with open(meta_path) as f:
        return int(json.load(f)["iteration"])


def _complete_interrupted_commit(seed_dirs: Sequence[str]):
    """Finish the renames of an evaluation that a kill interrupted: once
    any seed's checkpoint is at the newest iteration, every seed's pending
    files of it were written before the first rename, so the seeds behind
    take theirs. Pending files of an evaluation whose renames never began
    are left (the next evaluation replaces them)."""
    final = [_iteration(os.path.join(d, ckpt.CHECKPOINT_FILE + ".json"))
             for d in seed_dirs]
    known = [i for i in final if i is not None]
    if not known:
        return
    newest = max(known)
    for d, iteration in zip(seed_dirs, final):
        pending = os.path.join(d, ckpt.CHECKPOINT_FILE + PENDING + ".json")
        if iteration != newest and _iteration(pending) == newest:
            logger.info("Completing the interrupted checkpoint of %s at "
                        "iteration %d.", d, newest)
            _commit(d)


def load_campaign_checkpoints(seed_dirs: Sequence[str], k: int,
                              device: Union[str, torch.device] = "cuda"):
    """Restore every seed's running checkpoint for a campaign resume:
    ``(states, best, done)`` with ``done`` the seeds' common iteration.
    Refuses seeds at different iterations, or an iteration off the
    ``k``-step chunk grid (JAX's checks)."""
    _complete_interrupted_commit(seed_dirs)
    states, metas = [], []
    for d in seed_dirs:
        state, meta = ckpt.load_checkpoint(
            os.path.join(d, ckpt.CHECKPOINT_FILE), device)
        states.append(state)
        metas.append(meta)
    done_iters = sorted({int(m["iteration"]) for m in metas})
    if len(done_iters) != 1:
        raise ValueError(
            "cannot resume: per-seed checkpoints are at different "
            "iterations {} ({})".format(done_iters, tuple(seed_dirs)))
    done = done_iters[0]
    if done % k:
        raise ValueError(
            "cannot resume: checkpoint iteration {} is not on the "
            "{}-step chunk grid (did print_every/evaluate_every/"
            "steps_per_execution change?)".format(done, k))
    best = [{"iteration": m["best_iteration"],
             "accuracy": m["best_accuracy"],
             "exact_match": m["best_exact_match"]} for m in metas]
    return states, best, done


def campaign_record(seeds: Sequence[int], training_batch_size: int, k: int,
                    chunk_layout: str,
                    stratified_options: Optional[dict]) -> dict:
    """What a resume must repeat for the seeds' index streams to continue
    where they stopped (``campaign.json``)."""
    record = {"seeds": [int(s) for s in seeds],
              "training_batch_size": int(training_batch_size),
              "steps_per_chunk": int(k), "chunk_layout": chunk_layout,
              "stratified_options": (stratified_options or {})
              if chunk_layout == "stratified" else None}
    return json.loads(json.dumps(record))  # tuples as lists, as read back


def check_campaign(output_directory: str, record: dict):
    """Refuse a resume whose campaign record differs from ``record``."""
    path = os.path.join(output_directory, CAMPAIGN_FILE)
    if not os.path.isfile(path):
        raise ValueError(
            "cannot resume: {} holds no {} (the record of the seeds, batch "
            "size, chunk size and layout a resume must repeat)".format(
                output_directory, CAMPAIGN_FILE))
    with open(path) as f:
        saved = json.load(f)
    for key, value in record.items():
        if saved.get(key) != value:
            raise ValueError(
                "cannot resume: the campaign in {} ran with {} = {!r}, and "
                "this run asks for {!r}; the seeds' data order would not "
                "continue".format(output_directory, key, saved.get(key),
                                  value))


def _write_json(path: str, value: dict):
    with open(path + PENDING, "w") as f:
        json.dump(value, f, indent=4)
    os.replace(path + PENDING, path)


def train_multiseed(training_set, dev_set, config: ModelConfig,
                    optimizer: Adam, seeds: Sequence[int],
                    output_directory: str, max_training_iterations: int,
                    training_batch_size: int, steps_per_execution: int,
                    print_every: int, evaluate_every: int,
                    max_decoding_steps: int,
                    weight_target_loss: float = 0.3,
                    evaluation_batch_size: int = 256,
                    max_testing_examples: Optional[int] = None,
                    chunk_layout: str = "full",
                    stratified_options: Optional[dict] = None,
                    decode_dtype: Optional[str] = None,
                    resume_from_file: str = "",
                    device: Union[str, torch.device] = "cuda",
                    callback: Optional[Callable[[str, int, dict], None]]
                    = None, profile_dir: str = ""):
    """Train ``len(seeds)`` models together; returns (stacked state, each
    seed's best ``{"iteration", "accuracy", "exact_match"}``).

    The single-seed resident loop's alignment, metrics line (one per seed,
    ``[seed N]``), dev evaluation and best-on-exact-match checkpoints, per
    seed, into ``<output_directory>/seed_<s>/``; the JAX
    ``train_multiseed``'s arguments but the learning-rate ones (the
    schedule is ``optimizer``'s) and ``resume``: ``resume_from_file`` names
    the campaign's output directory, from whose ``seed_<s>/checkpoint``
    every seed resumes with its index stream replayed past the consumed
    blocks. ``callback(kind, iteration, values)`` sees each seed's windows
    and evaluations as ``train``'s does, ``values["seed"]`` the seed.
    """
    device = torch.device(device)
    seeds = [int(s) for s in seeds]
    if len(set(seeds)) != len(seeds):
        raise ValueError("repeated seeds in {}".format(seeds))
    if chunk_layout not in ("full", "stratified"):
        raise ValueError("chunk_layout must be 'full' or 'stratified', got "
                         "{!r}".format(chunk_layout))
    k = resolve_chunk_size(steps_per_execution, print_every, evaluate_every)
    record = campaign_record(seeds, training_batch_size, k, chunk_layout,
                             stratified_options)
    seed_dirs = [os.path.join(output_directory, "seed_{}".format(s))
                 for s in seeds]
    start_iteration = 1
    if resume_from_file:
        if os.path.realpath(resume_from_file) != \
                os.path.realpath(output_directory):
            raise ValueError(
                "a multi-seed campaign resumes from its own output "
                "directory: resume_from_file must name {!r} (where each "
                "seed's seed_<s>/checkpoint.msgpack is), not {!r}".format(
                    output_directory, resume_from_file))
        check_campaign(output_directory, record)
        states, best, done = load_campaign_checkpoints(seed_dirs, k, device)
        start_iteration = done + 1
        logger.info("Resumed %d-seed campaign at iteration %d (per-seed "
                    "best EM: %s).", len(seeds), done,
                    ["%.2f" % b["exact_match"] for b in best])
    else:
        states = [create_train_state(s, config, optimizer, device)
                  for s in seeds]
        best = [{"iteration": 1, "accuracy": 0.0, "exact_match": 0.0}
                for _ in seeds]
        for d in seed_dirs:
            os.makedirs(d, exist_ok=True)
        _write_json(os.path.join(output_directory, CAMPAIGN_FILE), record)

    host_data = host_resident_data(training_set)
    data = build_resident_data(training_set, device)

    def seed_stream(seed):
        rng = np.random.default_rng(seed)  # a single-seed run's epoch_rng
        if chunk_layout == "stratified":
            return stratified_index_block_stream(
                host_data.target_lengths, training_batch_size, k, rng,
                **(stratified_options or {}))
        return ((block, None) for block in index_block_stream(
            training_set.num_examples, training_batch_size, k, rng))

    streams = [seed_stream(s) for s in seeds]
    for stream in streams:  # past the blocks the checkpoints consumed
        for _ in range((start_iteration - 1) // k):
            next(stream)
    stacked = stack_train_states(states)
    del states
    chunk_fn = make_multiseed_train_chunk(config, optimizer,
                                          weight_target_loss)
    profiler = StepProfiler(profile_dir, start_step=start_iteration + 20)
    logger.info("Multi-seed training: %d seeds %s in one program, %d "
                "examples on the device (stored once), %d-step chunks.",
                len(seeds), tuple(seeds), training_set.num_examples, k)

    def log_metrics(iteration, metrics, steps_per_s):
        for i, s in enumerate(seeds):
            values = {name: float(metrics[name][i]) for name in metrics}
            values["learning_rate"] = float(optimizer.schedule(iteration - 1))
            values["steps_per_s"] = steps_per_s
            logger.info(
                "Iteration %08d [seed %d], loss %8.4f, accuracy %5.2f, "
                "exact match %5.2f, learning_rate %.5f, aux. accuracy "
                "target pos %5.2f, steps/s %6.2f"
                % (iteration, s, values["loss"], values["accuracy"],
                   values["exact_match"], values["learning_rate"],
                   values["aux_accuracy"], steps_per_s))
            if callback is not None:
                callback("train", iteration, dict(values, seed=s))

    def run_evaluation(iteration, stacked):
        results = []
        for i, s in enumerate(seeds):
            # The subset a single-seed run with this seed scores (C.10).
            dev_set.shuffle_data(np.random.default_rng(s))
            accuracy, exact_match, target_accuracy = evaluate(
                dev_set, slice_train_state(stacked, i).params, config,
                max_decoding_steps=max_decoding_steps,
                batch_size=evaluation_batch_size,
                max_examples_to_evaluate=max_testing_examples,
                decode_dtype=decode_dtype, device=device)
            logger.info(
                "  Evaluation [seed %d] Accuracy: %5.2f Exact Match: %5.2f "
                " Target Accuracy: %5.2f"
                % (s, accuracy, exact_match, target_accuracy))
            if callback is not None:
                callback("eval", iteration, {
                    "accuracy": accuracy, "exact_match": exact_match,
                    "target_accuracy": target_accuracy, "seed": s})
            results.append((accuracy, exact_match))
        # Every seed's files under pending names, then the renames: a kill
        # leaves either the last evaluation's checkpoints or this one's
        # (load_campaign_checkpoints finishes interrupted renames).
        for i, (accuracy, exact_match) in enumerate(results):
            for pending, _ in _pending_files(seed_dirs[i]):
                if os.path.exists(pending):
                    os.remove(pending)
            is_best = exact_match > best[i]["exact_match"]
            if is_best:
                best[i] = {"iteration": iteration, "accuracy": accuracy,
                           "exact_match": exact_match}
            path = ckpt.save_checkpoint(
                seed_dirs[i], slice_train_state(stacked, i),
                best_iteration=best[i]["iteration"],
                best_accuracy=best[i]["accuracy"],
                best_exact_match=best[i]["exact_match"],
                file_name=ckpt.CHECKPOINT_FILE + PENDING)
            if is_best:
                best_path = os.path.join(
                    seed_dirs[i], ckpt.BEST_CHECKPOINT_FILE + PENDING)
                for suffix in ("", ".json"):
                    shutil.copyfile(path + suffix, best_path + suffix)
        for d in seed_dirs:
            _commit(d)

    def tail_steps(stacked, steps):
        """The last partial chunk as single steps, each seed on the first
        ``steps`` rows of its next block (a single-seed run's tail)."""
        states = []
        for i, stream in enumerate(streams):
            state = slice_train_state(stacked, i)
            for row in next(stream)[0][:steps]:
                state, _ = train_step(state, gather_batch(data, row), config,
                                      optimizer, weight_target_loss)
            states.append(state)
        return stack_train_states(states)

    iteration = start_iteration
    window_start, window_steps = time.time(), 0
    while iteration <= max_training_iterations:
        if iteration + k - 1 > max_training_iterations:
            # No print or eval boundary falls inside a tail: k divides both.
            stacked = tail_steps(stacked,
                                 max_training_iterations - iteration + 1)
            break
        profiler.maybe_start(iteration)
        pairs = [next(stream) for stream in streams]
        segments = pairs[0][1]
        if any(spec != segments for _, spec in pairs):
            raise RuntimeError("the seeds' segment specs differ: {}".format(
                [spec for _, spec in pairs]))
        stacked, metrics = chunk_fn(stacked, data,
                                    np.stack([b for b, _ in pairs]),
                                    segments)
        profiler.maybe_stop(iteration)
        end_iteration = iteration + k - 1
        window_steps += k
        if end_iteration % print_every == 0:
            # On the host before the window closes (the device work is
            # then done); steps/s counts each seed's optimizer steps.
            last = {name: value[:, -1].tolist()
                    for name, value in metrics.items()}
            elapsed = time.time() - window_start
            log_metrics(end_iteration, last,
                        window_steps / max(elapsed, 1e-9))
            window_start, window_steps = time.time(), 0
        if end_iteration % evaluate_every == 0:
            run_evaluation(end_iteration, stacked)
            window_start, window_steps = time.time(), 0
        iteration = end_iteration + 1
    profiler.close()
    logger.info("Finished training.")
    return stacked, best
