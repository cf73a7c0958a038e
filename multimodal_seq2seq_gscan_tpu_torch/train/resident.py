"""Device-resident training data and K-step training chunks.

The port of the JAX package's ``train/resident.py``. The whole training
split lives on the device in compact dtypes (uint8 one-hot grids, int32
ids); each chunk runs K optimizer steps on batches gathered on the device
from a ``[K, B]`` block of permutation indices, the only per-chunk upload
besides K triples of Adam's scalars. The numpy index streams are the JAX
package's, verbatim, so that a seed gives the JAX data order.

On the card a chunk replays a CUDA graph of its K training steps (each the
gather, forward, backward, Adam and the metrics), captured once per
distinct (per-step widths, batch, data) and replayed once a chunk. (A
graph of one step replayed K times measured the same per step on the H100,
PERF.md; the chunk graph launches once.) The graph does the eager step's
arithmetic: step s's dropout generator is re-seeded from (the state's key,
s) before each replay (``CUDAGraph.register_generator_state``), Adam's bias
corrections and step size come from a buffer the host fills
(``Adam.scalars``), and the state lives in one flat buffer that each step
rewrites with its update. A multi-seed chunk (``train/multiseed.py``)
captures every seed's K steps in one graph, one seed after another, each
seed's state in its own row of that buffer. A graph that fails to capture
or replay raises; there is no eager fallback on the card. On the CPU a
chunk runs the same steps eagerly.
"""

import gc
import math
import warnings
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from multimodal_seq2seq_gscan_tpu_torch.core.batch import Batch
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.params import (
    leaves, tree_unflatten)
from multimodal_seq2seq_gscan_tpu_torch.train.state import (
    Adam, AdamState, TrainState)
from multimodal_seq2seq_gscan_tpu_torch.train.step import (
    step_seed, train_step)

METRIC_NAMES = ("loss", "accuracy", "exact_match", "aux_accuracy")


class ResidentData(NamedTuple):
    """The whole training split as flat columns (compact dtypes)."""

    input_ids: torch.Tensor         # [N, T_in]  int32
    input_lengths: torch.Tensor     # [N]        int32
    situations: torch.Tensor        # [N, H, W, C] uint8 (f32 per batch)
    target_ids: torch.Tensor        # [N, T_out] int32
    target_lengths: torch.Tensor    # [N]        int32
    agent_positions: torch.Tensor   # [N]        int32
    target_positions: torch.Tensor  # [N]        int32

    @property
    def num_examples(self) -> int:
        return self.input_ids.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


def host_resident_data(training_set) -> ResidentData:
    """The packed columns of a ``GroundedScanDataset`` as host numpy arrays
    (the one source of the column layout)."""
    training_set._ensure_packed()
    situations = training_set._situation_stack
    if situations.dtype != np.uint8:
        situations = situations.astype(np.uint8)
    return ResidentData(
        input_ids=np.ascontiguousarray(training_set._input_matrix),
        input_lengths=training_set._input_lengths,
        situations=np.ascontiguousarray(situations),
        target_ids=np.ascontiguousarray(training_set._target_matrix),
        target_lengths=training_set._target_lengths,
        agent_positions=training_set._agent_positions,
        target_positions=training_set._target_positions)


def build_resident_data(training_set,
                        device: Union[str, torch.device] = "cuda"
                        ) -> ResidentData:
    """The packed columns of a ``GroundedScanDataset`` on ``device``."""
    return ResidentData(*(torch.from_numpy(np.ascontiguousarray(a)).to(
        device) for a in host_resident_data(training_set)))


def gather_batch(data: ResidentData,
                 idx: Union[torch.Tensor, np.ndarray]) -> Batch:
    """Batch assembly on the data's device: one gather per column, the
    uint8 grid cast to float32."""
    index = torch.as_tensor(idx, dtype=torch.long,
                            device=data.input_ids.device)

    def take(column):
        return torch.index_select(column, 0, index)

    return Batch(
        input_ids=take(data.input_ids),
        input_lengths=take(data.input_lengths),
        situations=take(data.situations).float(),
        target_ids=take(data.target_ids),
        target_lengths=take(data.target_lengths),
        agent_positions=take(data.agent_positions),
        target_positions=take(data.target_positions))


def _narrowed(batch: Batch, width: int) -> Batch:
    """The batch with its target matrix narrowed to ``width`` columns."""
    if width < batch.target_ids.shape[1]:
        return batch._replace(target_ids=batch.target_ids[:, :width])
    return batch


def _step_widths(segments, steps: int, t_full: int) -> Tuple[int, ...]:
    """Each step's target width: ``t_full``, or its segment's (capped)."""
    if segments is None:
        return (t_full,) * steps
    widths = tuple(min(int(width), t_full) for count, width in segments
                   for _ in range(int(count)))
    if len(widths) != steps:
        raise ValueError("segments {} cover {} steps, the block {}".format(
            segments, len(widths), steps))
    return widths


def _stacked(metrics: List[Dict[str, torch.Tensor]]
             ) -> Dict[str, torch.Tensor]:
    return {name: torch.stack([m[name] for m in metrics])
            for name in METRIC_NAMES}


# A seed's row of a flat state buffer is rounded up to a multiple of this
# many floats (512 bytes), so that every seed's tensors lie at the
# alignment of a single seed's and the libraries pick the same algorithms
# for them.
ROW_ALIGN = 128


def state_row_floats(params) -> int:
    """The floats of one row of a flat state buffer: the params, mu and nu
    of a params tree of ``params``' layout, rounded up to ROW_ALIGN."""
    n = 3 * sum(t.numel() for t in leaves(params))
    return -(-n // ROW_ALIGN) * ROW_ALIGN


def flatten_state(state: TrainState, row: torch.Tensor):
    """Write the state's params, mu and nu, in that order, to the front of
    ``row``."""
    parts = [t.reshape(-1) for tree in (
        state.params, state.opt_state.mu, state.opt_state.nu)
        for t in leaves(tree)]
    torch.cat(parts, out=row[:sum(p.numel() for p in parts)])


def row_trees(row: torch.Tensor, template):
    """(params, mu, nu) as views of a row that ``flatten_state`` wrote;
    ``template`` (a params tree) gives the layout."""
    shapes = [t.shape for t in leaves(template)]
    views, offset = [], 0
    for _ in range(3):
        tree = []
        for shape in shapes:
            n = math.prod(shape)
            tree.append(row[offset:offset + n].view(shape))
            offset += n
        views.append(tree_unflatten(template, tree))
    return views


def eager_chunk(state: TrainState, data: ResidentData, idx_block: np.ndarray,
                segments, config: ModelConfig, optimizer: Adam,
                weight_target_loss: float
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """A chunk's steps one ``train_step`` at a time (the CPU's chunk):
    (state, metrics of ``[K]`` tensors)."""
    widths = _step_widths(segments, idx_block.shape[0],
                          data.target_ids.shape[1])
    metrics = []
    for row, width in zip(idx_block, widths):
        state, step_metrics = train_step(
            state, _narrowed(gather_batch(data, row), width), config,
            optimizer, weight_target_loss)
        metrics.append(step_metrics)
    return state, _stacked(metrics)


class ChunkGraphs:
    """The CUDA graphs of one chunk maker: the state buffer ``flat``
    (``[S, state_row_floats]``: seed s's params, mu and nu in row s), which
    every graph's steps read and rewrite, and one graph per key (per-step
    widths, batch, the data's columns). S is 1 for ``make_train_chunk`` and
    the number of seeds for a multi-seed chunk (``train/multiseed.py``)."""

    def __init__(self, config: ModelConfig, optimizer: Adam,
                 weight_target_loss: float):
        self.config, self.optimizer = config, optimizer
        self.weight_target_loss = weight_target_loss
        self.flat: Optional[torch.Tensor] = None
        self.template = None  # the first state's params: the rows' layout
        self.graphs: Dict[tuple, "_Graph"] = {}
        self.pool = None

    def bind(self, states: List[TrainState]):
        """Copy each state's params and moments into its row."""
        if self.flat is None:
            self.template = states[0].params
            self.flat = torch.zeros(
                (len(states), state_row_floats(self.template)),
                dtype=torch.float32,
                device=leaves(self.template)[0].device)
        elif len(states) != self.flat.shape[0]:
            raise ValueError("these graphs train {} seeds, not {}".format(
                self.flat.shape[0], len(states)))
        for row, state in zip(self.flat, states):
            flatten_state(state, row)

    def trees(self, row: torch.Tensor):
        """(params, mu, nu) as views of one row of ``flat``."""
        return row_trees(row, self.template)

    def graph(self, widths: Tuple[int, ...], batch: int, data: ResidentData
              ) -> "_Graph":
        key = (widths, batch, tuple(t.data_ptr() for t in data))
        if key not in self.graphs:
            self.graphs[key] = _Graph(self, widths, batch, data)
            self.pool = self.graphs[key].graph.pool()
        return self.graphs[key]

    def replay(self, states: List[TrainState], data: ResidentData,
               idx_blocks: np.ndarray, segments=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each state's K steps on its ``[K, B]`` block of ``idx_blocks``
        (``[S, K, B]``), one replay for all: (a copy of ``flat`` after
        them, the metrics ``[S, K, len(METRIC_NAMES)]``)."""
        _, steps, batch = idx_blocks.shape
        widths = _step_widths(segments, steps, data.target_ids.shape[1])
        self.bind(states)
        scalars = np.array([[self.optimizer.scalars(
            s.opt_state.count + k, s.opt_state.schedule_count + k)
            for k in range(steps)] for s in states], np.float32)
        seeds = [[step_seed(s.rng, s.step + k) for k in range(steps)]
                 for s in states]
        graph = self.graph(widths, batch, data)
        graph.idx.copy_(_pinned(idx_blocks.astype(np.int64)),
                        non_blocking=True)
        graph.scalars.copy_(_pinned(scalars), non_blocking=True)
        graph.replay(seeds)
        return self.flat.clone(), graph.metrics.clone()


class _Graph:
    """One captured graph of S x len(widths) training steps, the seeds one
    after another: seed s's step j gathers the rows idx[s, j], narrows the
    targets to widths[j], draws its dropout from generators[s][j], takes
    Adam's scalars from scalars[s, j], writes its metrics to metrics[s, j]
    and its update into row s of the shared buffer."""

    def __init__(self, owner: ChunkGraphs, widths: Tuple[int, ...],
                 batch: int, data: ResidentData):
        # No reference back to ``owner``: a cycle would leave a dead
        # holder's graphs to the cyclic garbage collector, which may run
        # during a later capture, and destroying a graph then invalidates
        # that capture.
        self.widths, self.data = widths, data
        device = owner.flat.device
        seeds, steps = owner.flat.shape[0], len(widths)
        self.idx = torch.zeros((seeds, steps, batch), dtype=torch.long,
                               device=device)
        self.scalars = torch.ones((seeds, steps, 3), dtype=torch.float32,
                                  device=device)
        self.metrics = torch.zeros((seeds, steps, len(METRIC_NAMES)),
                                   device=device)
        self.generators = [[torch.Generator(device=device)
                            for _ in range(steps)] for _ in range(seeds)]
        # Warm-up on a side stream (lazy initialisation, the kernels'
        # build and attributes) of one seed's steps, into a copy of its
        # row: the real state stays as it was.
        spare = owner.flat[0].clone()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._steps(owner, 0, spare, spare)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        for generator in (g for row in self.generators for g in row):
            self.graph.register_generator_state(generator)
        gc.collect()  # any dead graph elsewhere goes now, not mid-capture
        with torch.cuda.graph(self.graph, pool=owner.pool):
            for s, row in enumerate(owner.flat):
                self._steps(owner, s, row, row)

    def _steps(self, owner: ChunkGraphs, s: int, source: torch.Tensor,
               target: torch.Tensor):
        """Seed s's steps, reading its state from the row ``source`` and
        writing each update to ``target`` (the same row when captured)."""
        for j, width in enumerate(self.widths):
            params, mu, nu = owner.trees(source)
            state = TrainState(step=0, params=params,
                               opt_state=AdamState(0, mu, nu, 0),
                               rng=np.zeros(2, np.uint32))
            batch = _narrowed(gather_batch(self.data, self.idx[s, j]), width)
            new, metrics = train_step(
                state, batch, owner.config, owner.optimizer,
                owner.weight_target_loss, generator=self.generators[s][j],
                adam_scalars=self.scalars[s, j])
            flatten_state(new, target)
            self.metrics[s, j].copy_(torch.stack(
                [metrics[name] for name in METRIC_NAMES]))
            source = target

    def replay(self, seeds: List[List[int]]):
        for generators, row in zip(self.generators, seeds):
            for generator, seed in zip(generators, row):
                generator.manual_seed(seed)
        self.graph.replay()


def _pinned(array: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).pin_memory()


def make_train_chunk(config: ModelConfig, optimizer: Adam,
                     weight_target_loss: float = 0.3):
    """``chunk(state, data, idx_block, segments=None) -> (state, metrics)``:
    K optimizer steps on the batches ``gather_batch(data, idx_block[k])``,
    the same state and metrics as K ``train_step`` calls on those batches.

    ``idx_block`` is a ``[K, B]`` int array (numpy); the metrics dict has
    ``[K]`` tensors (loss, accuracy, exact_match, aux_accuracy; the last
    entry the most recent step). ``segments`` (``((count, width), ...)``
    with counts summing to K) narrows each group of rows' target matrix to
    ``width`` columns (exact where every row of the group fits it, which
    ``stratified_index_block_stream`` guarantees). On the card the steps
    replay a CUDA graph (module docstring). The state passed in is not
    modified.
    """
    graphs = ChunkGraphs(config, optimizer, weight_target_loss)

    def chunk(state: TrainState, data: ResidentData, idx_block,
              segments=None):
        idx_block = np.asarray(idx_block)
        if data.input_ids.device.type != "cuda":
            return eager_chunk(state, data, idx_block, segments, config,
                               optimizer, weight_target_loss)
        flat, metrics = graphs.replay([state], data, idx_block[None],
                                      segments)
        steps, opt = idx_block.shape[0], state.opt_state
        params, mu, nu = graphs.trees(flat[0])
        new_state = TrainState(
            step=state.step + steps, params=params,
            opt_state=AdamState(opt.count + steps, mu, nu,
                                opt.schedule_count + steps),
            rng=state.rng)
        return new_state, dict(zip(METRIC_NAMES, metrics[0].T))

    return chunk


# The index streams below are the JAX package's ``train/resident.py``
# (``index_block_stream`` to ``resolve_chunk_size``), verbatim: the same
# seed gives the same data order.


def index_block_stream(num_examples: int, batch_size: int,
                       steps_per_block: int,
                       rng: Optional[np.random.Generator] = None
                       ) -> Iterator[np.ndarray]:
    """Endless ``[K, B] int32`` permutation blocks.

    Epochs are seamless: each epoch is a fresh permutation of all examples,
    and a batch that would straddle an epoch boundary is filled from the next
    permutation — every batch is full and every example appears exactly once
    per epoch (the streaming loop's pad-final-batch semantics, without the
    padded rows).
    """
    if rng is None:
        rng = np.random.default_rng()
    need = steps_per_block * batch_size
    buffer = np.empty((0,), dtype=np.int64)
    while True:
        while buffer.size < need:
            buffer = np.concatenate([buffer, rng.permutation(num_examples)])
        block, buffer = buffer[:need], buffer[need:]
        yield np.ascontiguousarray(
            block.reshape(steps_per_block, batch_size).astype(np.int32))


def _class_widths(target_lengths: np.ndarray, width_multiple: int,
                  cuts=None) -> Tuple[np.ndarray, int]:
    """Per-example width class.

    Default: length rounded up to ``width_multiple``, capped at the global
    max length.  With ``cuts`` (sorted ints): the smallest cut >= length,
    else the global max — e.g. ``cuts=(32,)`` yields the two-class scheme
    {<=32, rest} whose wide class can be mixing-backfilled (``wide_mix``).
    """
    lengths = np.maximum(np.asarray(target_lengths), 1)
    t_max = int(lengths.max())
    if cuts:
        widths = np.full(lengths.shape, t_max, dtype=np.int64)
        for cut in sorted(cuts, reverse=True):
            if cut < t_max:
                widths[lengths <= cut] = cut
        return widths, t_max
    return np.minimum(t_max, -(-lengths // width_multiple)
                      * width_multiple).astype(np.int64), t_max


def _interleave_spec(spec: Tuple[Tuple[int, int], ...], rounds: int = 4
                     ) -> Tuple[Tuple[int, int], ...]:
    """Spread each class's step allocation over ``rounds`` round-robin
    passes (ascending width within each pass) so wide-batch updates are
    distributed through the chunk instead of bunched at its end.  Counts
    per class are preserved exactly; classes whose allocation is smaller
    than ``rounds`` appear in fewer passes."""
    out = []
    remaining = {w: c for c, w in spec}
    order = [w for _, w in spec]
    for r in range(rounds):
        for w in order:
            left = remaining[w]
            if left <= 0:
                continue
            take = -(-left // (rounds - r))  # ceil split of the remainder
            remaining[w] -= take
            out.append((take, w))
    return tuple(out)


def _effective_wide_mix(fractions: np.ndarray, steps_per_block: int,
                        wide_mix: float) -> float:
    """Resolve the wide-mix knob against the block size.

    The mixing scheme is only sound when the widest class's inflated
    allocation ``ceil(K * fraction / (1 - wide_mix))`` fits in ``K - 1``
    steps (at least one step must remain for the shorter classes, and the
    ceil is the per-epoch capacity guarantee: clamping below it starves the
    widest class — at ``K == 1`` it drops the widest class from the spec
    entirely, the stream then can never fill a block, and round 4 shipped
    exactly that livelock).  Degenerate configurations fall back to plain
    stratification (wide_mix = 0) with a warning instead of clamping into
    infeasibility, so the emitted spec ALWAYS contains a segment at least as
    wide as the true widest non-empty class.
    """
    if not wide_mix or len(fractions) < 2:
        return 0.0
    if not 0.0 < wide_mix < 1.0:
        raise ValueError("wide_mix must be in (0, 1), got %r" % wide_mix)
    wide_steps = int(math.ceil(steps_per_block * fractions[-1]
                               / (1.0 - wide_mix)))
    if steps_per_block < 2 or wide_steps > steps_per_block - 1:
        warnings.warn(
            "stratified wide_mix=%g needs %d of %d block steps for the "
            "widest class (plus >=1 for the rest); disabling wide_mix for "
            "this run — raise steps_per_execution (or align "
            "print_every/evaluate_every so the resolved chunk size is "
            "larger) to use it" % (wide_mix, wide_steps, steps_per_block),
            RuntimeWarning, stacklevel=3)
        return 0.0
    return wide_mix


def chunk_segment_spec(target_lengths: np.ndarray, steps_per_block: int,
                       width_multiple: int = 16, cuts=None,
                       wide_mix: float = 0.0, interleave: bool = False
                       ) -> Tuple[Tuple[int, int], ...]:
    """Static ``((count, width), ...)`` segments for one [K, B] train chunk,
    widths ascending, counts summing to K.

    Each chunk mirrors the dataset's target-length distribution: class j
    (lengths rounded up to ``width_multiple``, or binned by ``cuts``) gets
    ``floor(K * fraction_j)`` of the chunk's K batches, and the widest class
    absorbs the remainder, so every K-step device call sees the full length
    mix.  (A length-SORTED chunk stream was measured to destroy training —
    dev EM 2.2 vs 27.9 at 4k iterations — because ~85% of examples are
    short, so sorted chunks produce hundreds-of-steps runs without a single
    long-sequence update.)  Classes whose floor is 0 get no segment; their
    examples ride along in wider segments (always exact — a segment only
    requires width >= every row's length).

    ``wide_mix`` in (0, 1) inflates the widest class's allocation to
    ``K * fraction / (1 - wide_mix)`` steps so the stream can backfill that
    share of every wide batch with random shorter examples: the rare long
    examples then always train in mixed batches instead of segregated ones
    (the round-4 200k run showed fully width-homogeneous batches plateau
    ~1.4 dev-EM below full-width training).  ``interleave`` spreads each
    class's steps round-robin through the chunk instead of ascending runs.
    """
    widths, _ = _class_widths(target_lengths, width_multiple, cuts)
    classes, counts = np.unique(widths, return_counts=True)
    fractions = counts / counts.sum()
    wide_mix = _effective_wide_mix(fractions, steps_per_block, wide_mix)
    if wide_mix:
        # ceil: per-epoch wide-row capacity must be >= the wide class's
        # supply, otherwise the wide pool grows without bound across epochs
        # (the own-take cap below stops wide segments from draining it).
        # _effective_wide_mix guarantees this fits in steps_per_block - 1.
        wide_steps = int(math.ceil(steps_per_block * fractions[-1]
                                   / (1.0 - wide_mix)))
        rest = steps_per_block - wide_steps
        alloc = np.floor(fractions[:-1] / fractions[:-1].sum()
                         * rest).astype(int)
        # largest-remainder rounding for the shorter classes
        remainders = fractions[:-1] / fractions[:-1].sum() * rest - alloc
        for j in np.argsort(-remainders)[:rest - int(alloc.sum())]:
            alloc[j] += 1
        alloc = np.concatenate([alloc, [wide_steps]])
    else:
        alloc = np.floor(fractions * steps_per_block).astype(int)
        alloc[-1] += steps_per_block - int(alloc.sum())  # widest takes rest
    spec = tuple((int(a), int(w)) for a, w in zip(alloc, classes) if a > 0)
    return _interleave_spec(spec) if interleave else spec


def stratified_index_block_stream(target_lengths: np.ndarray, batch_size: int,
                                  steps_per_block: int,
                                  rng: Optional[np.random.Generator] = None,
                                  width_multiple: int = 16, cuts=None,
                                  wide_mix: float = 0.0,
                                  interleave: bool = False
                                  ) -> Iterator[tuple]:
    """Endless ``([K, B] int32 block, segment spec)`` pairs.

    Like ``index_block_stream`` (fresh permutation per epoch horizon, every
    example exactly once, seamless epoch boundaries), but each block's rows
    are laid out to match ``chunk_segment_spec``: the first ``c_1`` rows hold
    examples no longer than ``w_1``, the next ``c_2`` no longer than ``w_2``,
    and so on — so the chunk runs each segment's teacher-forced
    unroll at that segment's width instead of the ~104-token global max
    (most gSCAN targets are ~12-20 tokens, so this removes most of the
    sequential decoder latency that dominates the device step) while every
    device call still samples the whole length distribution.

    Segments are filled from their own length class first, then backfilled
    from shorter classes (exact: a row only needs width >= its length).
    With ``wide_mix`` the widest class's own-pool take is capped at
    ``(1 - wide_mix) * need`` per segment, so EVERY wide batch carries
    ~``wide_mix`` random shorter examples (without the cap the own-first
    rule would saturate early chunks with longs and leave later chunks'
    wide segments all-short).  When the remaining examples cannot fill a
    block (fewer than K*B left, or only over-long examples remain for some
    segment), the leftovers carry into the next epoch's pools and are
    consumed first.  Degenerate wide_mix configurations fall back to plain
    stratification via ``_effective_wide_mix`` (round 4 shipped a livelock
    here: at ``steps_per_block == 1`` the clamped spec dropped the widest
    class and no block was ever fillable); a progress guard backstops any
    residual infeasibility by raising instead of spinning.
    """
    if rng is None:
        rng = np.random.default_rng()
    target_lengths = np.asarray(target_lengths)
    widths, _ = _class_widths(target_lengths, width_multiple, cuts)
    classes, counts = np.unique(widths, return_counts=True)
    wide_mix = _effective_wide_mix(counts / counts.sum(), steps_per_block,
                                   wide_mix)
    spec = chunk_segment_spec(target_lengths, steps_per_block, width_multiple,
                              cuts, wide_mix, interleave)
    widest = max(w for _, w in spec)
    class_of = {w: np.flatnonzero(widths == w) for w in classes}
    pools = {w: np.empty((0,), np.int64) for w in class_of}
    stuck_refills = 0
    while True:
        for w, members in class_of.items():
            pools[w] = np.concatenate([pools[w], rng.permutation(members)])
        yielded_any = False
        while True:
            if sum(p.size for p in pools.values()) < steps_per_block * batch_size:
                break
            segments = []
            taken = {w: 0 for w in pools}
            feasible = True
            for count, width in spec:
                need = count * batch_size
                own_cap = need
                if wide_mix and width == widest:
                    own_cap = need - int(round(need * wide_mix))
                rows = []
                # own class first (capped), then widest-to-shortest of the
                # shorter classes
                for w in sorted((w for w in pools if w <= width),
                                key=lambda w: (w != width, -w)):
                    avail = pools[w].size - taken[w]
                    want = need - sum(r.size for r in rows)
                    if w == width:
                        want = min(want, own_cap)
                    grab = min(want, avail)
                    if grab <= 0:
                        continue
                    rows.append(pools[w][taken[w]:taken[w] + grab])
                    taken[w] += grab
                    if sum(r.size for r in rows) == need:
                        break
                if sum(r.size for r in rows) != need:
                    feasible = False
                    break
                seg = np.concatenate(rows)
                rng.shuffle(seg)
                segments.append(seg.reshape(count, batch_size))
            if not feasible:
                break
            for w in pools:
                pools[w] = pools[w][taken[w]:]
            block = np.concatenate(segments, axis=0)
            yielded_any = True
            yield (np.ascontiguousarray(block.astype(np.int32)), spec)
        # Progress guard: an epoch refill adds every example once, so if a
        # refill that brought supply above one block's worth still yielded
        # nothing, another identical refill cannot help — raise instead of
        # growing the pools forever (the round-4 livelock mode).
        if yielded_any:
            stuck_refills = 0
        elif sum(p.size for p in pools.values()) >= steps_per_block * batch_size:
            stuck_refills += 1
            if stuck_refills >= 2:
                raise RuntimeError(
                    "stratified_index_block_stream made no progress over two "
                    "consecutive epoch refills: spec=%r, pool sizes=%r, "
                    "batch_size=%d, steps_per_block=%d" % (
                        spec, {w: int(p.size) for w, p in pools.items()},
                        batch_size, steps_per_block))


def resolve_chunk_size(steps_per_execution: int, print_every: int,
                       evaluate_every: int) -> int:
    """Largest chunk size <= steps_per_execution that divides both logging
    periods, so print/eval boundaries always land between device calls."""
    period = math.gcd(int(print_every), int(evaluate_every))
    k = max(1, min(int(steps_per_execution), period))
    while period % k:
        k -= 1
    return k
