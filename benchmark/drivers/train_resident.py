"""Resident training: the port's graphed K-step chunks
(``train/resident.py::make_train_chunk``), driven as
``train/loop.py::_train_resident`` drives them, without evaluations or
checkpoints: the split on the device, each chunk's ``[K, B]`` rows from
the seamless permutation stream of ``index_block_stream`` seeded by the
run's seed, the last step's metrics read on the host at the end of every
``print_every`` steps (the loop's logging boundary; between them the host
queues the next chunk while the device runs this one).

Set-up builds one chunk maker and one training state from the seed and
drives them through a call of one step (whose state gives step 1's
gradient, Adam's mu) and then a first chunk of the window's own K steps,
which captures the window's graph and replays it. The reference follows
those 1 + K steps: every step's loss, step 1's gradient and the change
after step 1 + K. The window continues the same state through the same
graph.
"""

import gc
from typing import NamedTuple

import numpy as np
import torch

from benchmark.harness import checks, fixture, program, weights
from benchmark.reference.model import Arithmetic, full_float32
from benchmark.reference.train import Followed, follow

class RowStream:
    """Each step's B example indices: a frozen copy of the port's
    ``index_block_stream`` (fresh permutations of the split, seamless at
    epoch ends), taken a given number of steps at a time."""

    def __init__(self, num_examples: int, batch: int, seed: int):
        self.num_examples, self.batch = num_examples, batch
        self.rng = np.random.default_rng(seed)
        self.buffer = np.empty((0,), np.int64)

    def take(self, steps: int) -> np.ndarray:
        need = steps * self.batch
        while self.buffer.size < need:
            self.buffer = np.concatenate(
                [self.buffer, self.rng.permutation(self.num_examples)])
        block, self.buffer = self.buffer[:need], self.buffer[need:]
        return np.ascontiguousarray(
            block.reshape(steps, self.batch).astype(np.int32))


class Finished(NamedTuple):
    rows: np.ndarray          # [1 + K, B] the first steps' rows
    program: Followed         # the program's first 1 + K steps (host):
    # each step's loss, step 1's gradient from Adam's mu, the parameters
    split: fixture.Split


class Session:
    def __init__(self, bench):
        from multimodal_seq2seq_gscan_tpu_torch.train.resident import (
            ResidentData, make_train_chunk, resolve_chunk_size)
        from multimodal_seq2seq_gscan_tpu_torch.train.state import (
            Adam, TrainState)
        cfg, traffic, device = (bench.cell.config, bench.cell.traffic,
                                bench.device)
        program.load_kernels(device)
        self.split = fixture.load_split(bench.root, cfg["data"], "train",
                                        bucket_inputs=False)
        vocab_in, vocab_out = fixture.vocabulary_sizes(bench.root,
                                                       cfg["data"])
        channels = self.split.situations.shape[-1]
        leaves = weights.layout(cfg, vocab_in, vocab_out, channels)
        self.config = program.model_config(cfg, vocab_in, vocab_out, channels)
        optimizer = Adam(learning_rate=cfg["learning_rate"],
                         b1=cfg["adam_beta_1"], b2=cfg["adam_beta_2"],
                         lr_decay=cfg["lr_decay"],
                         lr_decay_steps=cfg["lr_decay_steps"])
        self.b1 = cfg["adam_beta_1"]
        params = program.model_params(weights.generate(leaves, bench.seed,
                                                       device))
        state = TrainState(step=0, params=params,
                           opt_state=optimizer.init(params),
                           rng=weights.key(bench.seed))
        self.k = resolve_chunk_size(traffic["steps_per_execution"],
                                    traffic["print_every"],
                                    traffic["evaluate_every"])
        self.batch = cfg["training_batch_size"]
        self.print_every = traffic["print_every"]
        self.steps = 0
        self.data = ResidentData(*(torch.from_numpy(
            np.ascontiguousarray(a)).to(device) for a in self.split))
        self.chunk = make_train_chunk(
            self.config, optimizer,
            weight_target_loss=cfg["weight_target_loss"])
        self.rows = RowStream(self.split.num_examples, self.batch, bench.seed)
        # Step 1 alone: Adam's mu after it is step 1's gradient times 1 - b1.
        first = [self.rows.take(1)]
        state, metrics = self.chunk(state, self.data, first[0])
        losses = [float(metrics["loss"][0])]
        grads = {n: (m / (1.0 - self.b1)).cpu() for n, m in
                 program.named(state.opt_state.mu).items()}
        # Steps 2 to 1 + K: the window's graph, captured and replayed.
        first.append(self.rows.take(self.k))
        self.state, metrics = self.chunk(state, self.data, first[1])
        losses.extend(float(v) for v in metrics["loss"])
        self.first = Finished(np.concatenate(first), Followed(
            losses, grads, {n: t.cpu() for n, t in
                            program.named(self.state.params).items()}),
            self.split)

    def unit(self, tracer) -> np.ndarray:
        """One chunk; its record is its block of rows."""
        block = self.rows.take(self.k)
        with tracer.span("chunk"):
            self.state, metrics = self.chunk(self.state, self.data, block)
        self.steps += self.k
        if self.steps % self.print_every == 0:
            with tracer.span("read_result"):
                self.logged = {name: float(value[-1])
                               for name, value in metrics.items()}
        return block

    def end_to_end(self, units, window_s):
        examples = len(units) * self.k * self.batch
        return {"train_ex_per_s": examples / window_s}

    def counts(self, blocks) -> dict:
        """Each traced step's rows: the row-steps their targets need (each
        row up to its target length) and their command lengths."""
        steps = [rows for block in blocks for rows in block]
        cfg = self.config
        return {
            "kind": "train",
            "steps": len(steps),
            "batch": self.batch,
            "row_steps": [int((self.split.target_lengths[r] - 1).sum())
                          for r in steps],
            "input_lengths": [self.split.input_lengths[r] for r in steps],
            "m_t": self.split.input_ids.shape[1],
            "m_v": int(np.prod(self.split.situations.shape[1:3])),
            "grid": self.split.situations.shape[1],
            "channels": self.split.situations.shape[-1],
            "hidden": cfg.decoder_hidden_size,
            "vocab": cfg.target_vocabulary_size,
        }

    def finish(self) -> Finished:
        del self.chunk, self.state, self.data
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return self.first


def batches(split: fixture.Split, rows: np.ndarray, device):
    """The reference's batches of these steps' rows: input ids, lengths,
    situations and target ids on ``device``."""
    def take(column, r):
        return torch.from_numpy(np.ascontiguousarray(column[r])).to(device)
    return [(take(split.input_ids, r), take(split.input_lengths, r),
             take(split.situations, r).float(), take(split.target_ids, r))
            for r in rows]


def follow_reference(bench, finished: Finished, arithmetic: Arithmetic):
    """The reference's first steps from the seed's weights, made anew."""
    cfg = bench.cell.config
    leaves = weights.layout(cfg, *fixture.vocabulary_sizes(bench.root,
                                                           cfg["data"]),
                            finished.split.situations.shape[-1])
    W0 = weights.generate(leaves, bench.seed, bench.device)
    with full_float32():
        followed = follow(W0, cfg, batches(finished.split, finished.rows,
                                           bench.device),
                          weights.key(bench.seed), arithmetic)
    return W0, followed


def numbers(bench, finished: Finished) -> dict:
    W0, ref = follow_reference(bench, finished, Arithmetic(tf32=False))
    return _against(W0, finished.program, ref)


def readings(bench, finished: Finished) -> dict:
    """The numbers of the program, of the control (the reference in TF32
    put in the program's place) and of a fault planted in the reference
    put in its place (each step's loss the mean over half of its batch),
    against one run of the reference."""
    W0, ref = follow_reference(bench, finished, Arithmetic(tf32=False))
    _, control = follow_reference(bench, finished, Arithmetic(tf32=True))
    half = finished._replace(rows=finished.rows[:, :finished.rows.shape[1]
                                                // 2])
    _, faulty = follow_reference(bench, half, Arithmetic(tf32=False))
    return {"program": _against(W0, finished.program, ref),
            "control": _against(W0, control, ref),
            "fault": _against(W0, faulty, ref)}


def _against(W0, other: Followed, ref: Followed) -> dict:
    """The numbers of ``other``'s first steps against the reference's."""
    start = {n: w.cpu() for n, w in W0.items()}
    return checks.training_numbers(
        other.losses, ref.losses,
        {n: g.cpu() for n, g in other.first_grads.items()},
        {n: g.cpu() for n, g in ref.first_grads.items()},
        {n: other.params[n].cpu() - start[n] for n in start},
        {n: ref.params[n].cpu() - start[n] for n in start})
