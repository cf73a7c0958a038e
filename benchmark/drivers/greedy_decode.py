"""Whole-split greedy decode: the port's batched decoder
(``decode/greedy.py::make_greedy_decoder``, kernel 2 on the card) in a
closed loop, one batch in flight.

The split lives on the device. Each batch is drawn from the seed as whole
permutations of the split, concatenated and cut to the batch size, so
every batch, under every seed, holds the same examples (the same work)
in another order. The three outputs (tokens and both attention stacks)
are reduced on the device into a checksum that the host reads once a
batch, so no output goes unmade; a batch's latency runs from drawing its
rows to the host holding that checksum.

For the check a sample of ``checked_batches`` batches is drawn from the
seed as the batches come (a reservoir, so the sample is uniform over
however many batches the window holds and its memory is fixed); a
batch of the sample keeps a few of its rows (drawn from the seed, and
the batch's longest) with all their outputs, and once the window has
closed the sample is replayed through the reference. The checksum and
the kept rows are the harness's own device work, in the span
``checksum``, which the launch count leaves out.
"""

import gc
import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.harness import checks, fixture, program, weights
from benchmark.harness.trace import Tracer
from benchmark.reference.decode import replay
from benchmark.reference.model import Arithmetic, full_float32


def model_weights(bench, channels: int):
    """(the named weights, the input and target vocabulary sizes): the
    configuration's trained checkpoint, whose embeddings give the
    vocabularies it was trained with, else weights from the seed over the
    vocabulary files' sizes (made anew on each call)."""
    cfg = bench.cell.config
    if cfg.get("checkpoint"):
        arrays = weights.read_checkpoint(bench.root / cfg["checkpoint"])
        sizes = (arrays["encoder.embedding"].shape[0],
                 arrays["decoder.embedding"].shape[0])
        leaves = weights.layout(cfg, *sizes, channels)
        return weights.from_arrays(leaves, arrays, bench.device), sizes
    sizes = fixture.vocabulary_sizes(bench.root, cfg["data"])
    leaves = weights.layout(cfg, *sizes, channels)
    return weights.generate(leaves, bench.seed, bench.device), sizes


class Finished(NamedTuple):
    examples: torch.Tensor    # [R] split rows of the kept batch rows
    tokens: torch.Tensor      # [R, S] int32
    emitted: torch.Tensor     # [R, S]
    lengths: torch.Tensor     # [R]
    attn_cmd: torch.Tensor    # [R, S, M_t]
    attn_sit: torch.Tensor    # [R, S, M_v]
    steps_run: torch.Tensor   # [R] decoder steps the row's batch ran
    split: fixture.Split


class Session:
    def __init__(self, bench):
        from multimodal_seq2seq_gscan_tpu_torch.decode.greedy import (
            make_greedy_decoder)
        cfg, traffic, device = (bench.cell.config, bench.cell.traffic,
                                bench.device)
        program.load_kernels(device)
        self.bench = bench
        self.split = fixture.load_split(bench.root, cfg["data"],
                                        traffic["split"], bucket_inputs=True)
        channels = self.split.situations.shape[-1]
        named, vocabularies = model_weights(bench, channels)
        self.params = program.model_params(named)
        self.config = program.model_config(cfg, *vocabularies, channels)
        self.steps = cfg["max_decoding_steps"] + 1
        self.block = traffic["exit_check_every"]
        self.decode = make_greedy_decoder(
            self.config, cfg["max_decoding_steps"],
            exit_check_every=self.block, decode_impl=traffic["decode_impl"])
        self.batch = traffic["batch_size"]
        self.data = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                          for a in (self.split.input_ids,
                                    self.split.input_lengths,
                                    self.split.situations,
                                    self.split.target_positions))
        self.rows_rng = np.random.default_rng(bench.seed)
        self.keep_rng = np.random.default_rng([bench.seed, 1])
        self.sample_rng = np.random.default_rng([bench.seed, 2])
        self.keep_random = traffic["kept_random_rows"]
        self.keep_longest = traffic["kept_longest_rows"]
        self.checked = traffic["checked_batches"]
        self.kept, self.seen = [], 0
        self.next = self._draw()
        for _ in range(traffic["warmup_batches"]):
            self.unit(Tracer(False))
        self.kept, self.seen = [], 0

    def _draw(self):
        """The next batch's rows (whole permutations of the split) and the
        rows it keeps, drawn on the host into pinned memory."""
        n = self.split.num_examples
        rows = np.concatenate([self.rows_rng.permutation(n) for _ in
                               range(-(-self.batch // n))])[:self.batch]
        keep = self.keep_rng.choice(self.batch, self.keep_random,
                                    replace=False)
        pair = torch.from_numpy(rows), torch.from_numpy(keep)
        if self.bench.device == "cuda":
            pair = tuple(t.pin_memory() for t in pair)
        return pair

    def _slot(self):
        """This batch's place in the sample, or None: the reservoir's rule
        (the first ``checked`` batches, then batch i at a slot drawn
        uniformly from i + 1, kept where the slot is one of them)."""
        i, self.seen = self.seen, self.seen + 1
        if i < self.checked:
            self.kept.append(None)
            return i
        slot = int(self.sample_rng.integers(0, i + 1))
        return slot if slot < self.checked else None

    def unit(self, tracer):
        """One batch; its record is its rows and emitted lengths."""
        device = self.bench.device
        rows, keep = self.next
        slot = self._slot()
        with tracer.span("decode_batch"):
            index = rows.to(device, non_blocking=True)
            ids, lengths, situations, positions = self.data
            out = self.decode(self.params, ids[index], lengths[index],
                              situations[index].float(), positions[index])
            with tracer.span("checksum"):
                summary = torch.stack([
                    out.tokens.sum().float(), out.attention_commands.sum(),
                    out.attention_situations.sum(),
                    out.lengths.max().float()])
                if slot is not None:
                    kept = torch.cat([
                        keep.to(device, non_blocking=True),
                        torch.topk(out.lengths, self.keep_longest).indices])
                    kept_outputs = (index[kept], out.tokens[kept],
                                    out.emitted_mask[kept], out.lengths[kept],
                                    out.attention_commands[kept],
                                    out.attention_situations[kept])
        # The host draws the next batch while the device finishes this one.
        self.next = self._draw()
        with tracer.span("read_result"):
            values = summary.cpu()
        if slot is not None:
            self.kept[slot] = kept_outputs + (int(values[3]),)
        return rows.numpy(), out.lengths

    def end_to_end(self, units, window_s):
        latencies = [(end - began) * 1e3 for began, end in units]
        return {
            "decode_ex_per_s": len(units) * self.batch / window_s,
            "decode_batch_p95_ms": float(np.percentile(latencies, 95)),
        }

    def counts(self, batches) -> dict:
        """Each traced batch's command lengths and emitted lengths."""
        return {
            "kind": "decode",
            "batches": len(batches),
            "batch": self.batch,
            "input_lengths": [self.split.input_lengths[r]
                              for r, _ in batches],
            "lengths": [lengths.cpu().numpy() for _, lengths in batches],
            "block": self.block,
            "steps": self.steps,
            "m_t": self.split.input_ids.shape[1],
            "m_v": int(np.prod(self.split.situations.shape[1:3])),
            "grid": self.split.situations.shape[1],
            "channels": self.split.situations.shape[-1],
            "hidden": self.config.decoder_hidden_size,
            "vocab": self.config.target_vocabulary_size,
        }

    def finish(self) -> Finished:
        picked = self.kept
        fields = [torch.cat([p[j] for p in picked]) for j in range(6)]
        steps_run = torch.cat([
            torch.full((p[0].shape[0],), self._steps_run(p[6]),
                       device=fields[0].device) for p in picked])
        del self.decode, self.params, self.data, self.kept
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return Finished(*fields, steps_run, self.split)

    def _steps_run(self, longest: int) -> int:
        """Steps a batch runs whose longest row emits ``longest`` steps:
        whole blocks until every row is done, at most the cap."""
        blocks = max(1, math.ceil(longest / self.block))
        return min(blocks * self.block, self.steps)


def inputs(finished: Finished, device):
    split, rows = finished.split, finished.examples.cpu().numpy()
    return tuple(torch.from_numpy(np.ascontiguousarray(column[rows])).to(
        device) for column in (split.input_ids, split.input_lengths,
                                split.situations))


def reference_replay(bench, finished: Finished, arithmetic: Arithmetic):
    channels = finished.split.situations.shape[-1]
    W, _ = model_weights(bench, channels)
    with full_float32():
        return replay(arithmetic, W, bench.cell.config,
                      *inputs(finished, bench.device), finished.tokens,
                      finished.steps_run)


def _numbers(finished: Finished, ref) -> dict:
    return {
        "token_gap": checks.token_gap(ref.logits, finished.tokens,
                                      ref.lengths),
        "attn_gap": checks.attention_gap(finished.attn_cmd,
                                         finished.attn_sit, ref.attn_cmd,
                                         ref.attn_sit),
        "exit_faults": checks.exit_faults(finished.tokens, finished.emitted,
                                          finished.lengths, ref.lengths),
    }


def numbers(bench, finished: Finished) -> dict:
    return _numbers(finished, reference_replay(bench, finished,
                                               Arithmetic(tf32=False)))


def readings(bench, finished: Finished) -> dict:
    """The numbers of the program; of the control, the reference in TF32
    replaying the same tokens (the gap, in the float32 reference's logits,
    of the token the control puts first, and its attention against the
    float32 reference's); and of a token altered where it is produced
    (each row's first served action, ids from 3 up, replaced by another:
    3, or 4 for a 3)."""
    ref = reference_replay(bench, finished, Arithmetic(tf32=False))
    control = reference_replay(bench, finished, Arithmetic(tf32=True))
    tokens = finished.tokens.clone()
    first = tokens[:, 0]
    altered = torch.where(first == 3, torch.full_like(first, 4),
                          torch.full_like(first, 3))
    tokens[:, 0] = torch.where(first > 2, altered, first)
    return {
        "program": _numbers(finished, ref),
        "control": {
            "token_gap": checks.token_gap(ref.logits,
                                          control.logits.argmax(dim=-1),
                                          ref.lengths),
            "attn_gap": checks.attention_gap(control.attn_cmd,
                                             control.attn_sit, ref.attn_cmd,
                                             ref.attn_sit)},
        "fault": numbers(bench, finished._replace(tokens=tokens)),
    }
