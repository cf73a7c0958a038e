#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

It builds the port's CUDA kernels from ``multimodal_seq2seq_gscan_tpu_torch/
csrc`` (one ``nvcc`` per source, all at once, into ``build/torch_kernels/``),
holds each kernel against its plain PyTorch version on the card at the shapes
of the main path (kernel 2 on both launches of the fixture's decode: from
SOS, and from the state after the first block, most rows done at entry; and
on random weights from SOS and with 90% of the rows done at entry), then
drives the main path: the trained fixture checkpoint
(``data/bench_fixture/model_best.msgpack``) greedily decodes the fixture's
4096 dev examples at batch 4096 (120-step cap, early exit checked every 32
steps), once through kernel 2 (the decode block) and once through its plain
version, and the first 512 examples through the step-by-step decoder, whose
attentions are kernel 1. The kernel paths must give the plain path's tokens
on every example, apart from steps that are argmax near-ties in the plain
path (top-2 logit gap below 1e-4), which are counted and printed. The
teacher-forced kernels (3, 4 and the weight-gradient helper) are held to
their plain versions on random inputs at B=200, T=56 and T=53, and, with the
plain versions, to float64 on the fixture's train batches. Every kernel is
then held, and timed, at three shapes past the attention's register-resident
form and past the resident weight slices of kernels 3 and 4 (a 9x9 grid,
H=E=136, H=E=256 with 72 command keys and a 12x12 grid; the helper beside
its library call), and kernel 2 past its ring plans, on its grid plan
(H=E=449, 640, 1024 at batch 1024, and a second block at H=E=640 with 90%
of the rows done at entry), and kernels 3 and 4 past every cluster plan, on
their grid plans (H=E=449, 512, 640, 1024 at B=200, T=56); these rows also
stand, as ``wide`` lists, on their kernels' entries of the final kernels
line. The decode's examples are also
written as ``predict.json`` (``predict_and_save``) and scored by
``evaluate``, held to the decode's tokens and exact match. The second main path resumes training from the
fixture checkpoint for 20 steps at batch 200 through ``train()``, streamed
(kernels 3 and 4, then a dev decode through kernel 2), round-trips the
checkpoint, and compares 5 steps of the kernel path with the plain path;
the third trains on the resident path: chunks of 10 steps replayed from
CUDA graphs, held to as many eager steps (full and stratified layouts),
timed against the streamed step with the device busy share of each, then
``train(steps_per_execution=10)`` to step 200020 with its dev evaluation.
At H=E=512, a decoder width no cluster plan of kernels 3 and 4 fits, the
default "fused" path on random weights trains a graphed resident chunk of 4
steps (kernels 3 and 4 on their grid plans), held to 4 eager steps of the
plain unroll at the JAX bars. The same width then runs through every entry
point ("the wide decoder", encoder and decoder H = 512, embedding 25):
200 graphed steps from seed 42's init, then (a) ``train`` resumed for one
step and two chunks of 4 with dev evaluations of 512, writing model_best,
held to the same run on the plain versions (per-step loss, params,
evaluations), and 4 streamed steps; (b) the block decode of 512 dev
examples with that model_best against ``block_plain``, kernel 2's two
blocks timed, and the predict checks below on them; (c) the three bf16
decodes, each against the same decode on kernel 1's plain version (rows
may part only at argmax near-ties), and the float32 step decode; (d) a
campaign of two seeds, each bit for bit its single-seed run; (e) a
one-rank NCCL chunk and sharded decode, bit for bit the unsharded; (f) the
command-line checks below, ``--mode=test`` on the run's model_best. The
plans of kernels 2, 3 and 4 at that width are printed and required to be
the grid plans, and one profiled step and decode must show their grid
kernels and the helper's wide tiles.
The command line runs in process (``cli/seq2seq.py``'s ``main``):
``--mode=train`` resumed to 200020 in graphed chunks with a dev evaluation
of 512 examples, then ``--mode=test``, whose ``dev_predict.json`` must hold
the decode phase's predictions and be byte for byte the in-process
``predict_and_save`` of the same checkpoint. The 4096 examples are also
decoded in each bf16 variant (``bfloat16``, ``bfloat16_mixed``,
``bfloat16_keys``: the step path, kernel 1's bf16 form), held to the JAX
package's bars against the float32 decode; kernel 1's bf16 form is held to
its plain version and to float64 at the decode's shapes, W3's and H = 512,
and timed beside its bound; and a
decoder of two layers on random weights trains one graphed resident chunk
of its step unroll (kernel 1), held to as many eager steps. A multi-seed
campaign (seeds 66, 49 and 50, fresh from each seed's init, 20 steps in
graphed chunks of 10, a dev evaluation of 512 examples per seed through
kernel 2 after each chunk) is held, seed by seed, to single-seed
``train(seed=s)`` runs of the same steps, and a campaign stopped after its
first chunk and resumed to the uninterrupted one; its graph is timed
against the seeds' single-seed graphs replayed in turn. The port's C++
dataset scanner is built from the checkout, loads the fixture as the json
path does (arrays, strings, vocabularies), is what ``"auto"`` takes, and
its ``--mode=test`` writes the json path's ``dev_predict.json`` byte for
byte. The dataset engine (``gscan/``, ``analysis/``, ``cli/gscan.py``)
re-derives the target commands of all 4,608 fixture examples with its
oracle, generates 2,000 generalization examples (statistics, SVG plots,
PNG renders and GIFs checked), adds up to 200 by GECA (loaded alike by the
native scanner and json), trains on them from a fresh init through
``cli/seq2seq.py`` (20 steps in graphed chunks of 10: kernels 3, 4 and the
helper, a falling loss), decodes their test split (kernel 2) and runs the
three analysis modes on its ``predict.json``. Data
parallelism (``parallel/``) runs twice: in process, a one-rank NCCL
group trains a graphed resident chunk of 10 steps whose graph holds the
step's all-reduces, bit for bit the unsharded chunk, and decodes the 4096
examples (kernel 2) bit for bit as the decode phase; then two ranks share
the card over gloo (``parallel/launch.py``; NCCL refuses two ranks on one
device): 20 streamed training steps held to the train phase's run, the
decode of the 4096 (2048 a rank) held to its tokens, and a predict.json of
512 examples held to the single process's (byte for byte at the ranks'
batch of 256); the dry run's ``entry()`` computes its loss on the card,
held to its CPU loss. Then it times each kernel and its plain version with CUDA
events (kernel 2 on both of the fixture's blocks, each beside its own bound),
the full decode and the train step, and profiles one decode and three train
steps with torch.profiler (device busy share; for the decode, kernel 2's and
the encoder's device time).

Every phase prints its wall time. Any failure raises, so the exit code is not
0 and the final line is not printed. The last lines are: the card's name and
power limit as nvidia-smi reports them, a ``kernels:`` summary, one JSON
object describing each kernel (launches on the main path, error against the
plain version, times, bound), and the result line
``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "data" / "bench_fixture"
MAX_DECODING_STEPS = 120
EXIT_CHECK_EVERY = 32
BATCH = 4096
# The first BATCH fixture dev rows that each bf16 decode variant of the JAX
# package decodes otherwise than its float32 decode, on the CPU
# (scripts/bf16_decode_flips.py; the same at batch 64, 512 and 4096;
# tests/test_torch_decode_dtype.py holds the port to JAX on two windows).
JAX_BF16_FLIPS = {"bfloat16": (289, 1445, 1756, 1908, 2329, 3110),
                  "bfloat16_mixed": (1445, 1756, 1908, 2329, 3110),
                  "bfloat16_keys": (1908,)}
STEP_EXAMPLES = 512
NEAR_TIE = 1e-4
DEVICE = "cuda"
# Training: the README's batch, resumed from the fixture's step 200000 on
# its 512 train examples; T is the train split's padded target width.
TRAIN_BATCH = 200
TRAIN_T = 56
TRAIN_STEPS = 20
PRINT_EVERY = 5
COMPARE_STEPS = 5
SEED = 42

# Shapes past the attention's register-resident form (M <= 64, H <= 128)
# and past kernels 3 and 4 holding the weight slices in shared memory:
# (name, H = E, M_t, M_v). W1 is a 9x9 grid; W3 has masks of 1..72 keys and
# a 12x12 grid. Kernels 1 and 2 run them at the decode's batch, kernels 3, 4
# and the helper at the training batch, checked at T = WIDE_T and timed at
# TRAIN_T.
WIDE_SHAPES = (("W1", 100, 16, 81), ("W2", 136, 16, 36), ("W3", 256, 72, 144))
WIDE_T = 24
# Kernels 3 and 4 past every cluster plan, on their grid plans: (name, H =
# E), at M_t = 16, M_v = 36, the training batch, held at T = WIDE_T and
# timed at TRAIN_T. H512 is C.12's width, the first the cluster plans
# refused.
WIDE_TEACHER_FORCED = (("W4", 449), ("H512", 512), ("W5", 640),
                       ("W6", 1024))
# The training main path at a decoder width no cluster plan fits (C.12):
# H = E = WIDE_TRAIN_H on random weights, a graphed resident chunk of
# WIDE_TRAIN_K steps.
WIDE_TRAIN_H = 512
WIDE_TRAIN_K = 4
# The wide decoder through the entry points (encoder and decoder H =
# WIDE_TRAIN_H, embedding 25, where kernels 2, 3 and 4 take their grid
# plans): WIDE_PRETRAIN steps from
# SEED's init in graphed chunks of WIDE_PRETRAIN_K (the fixture's dev exact
# match is above 0 by then, so the paths' evaluations write model_best),
# then each path from that state in chunks of WIDE_TRAIN_K; decodes and
# evaluations of WIDE_EXAMPLES dev examples; a campaign of WIDE_SEEDS.
WIDE_PRETRAIN = 200
WIDE_PRETRAIN_K = 10
WIDE_EXAMPLES = 512
WIDE_SEEDS = (7, 8)
# Kernel 2 past its ring plans (H <= 256), on its grid plan: (name, H = E,
# share of rows done at entry), at M_t = 16, M_v = 36, V = 9, K = 32 steps
# and batch PAST_448_BATCH (each launch well under 1 s).
PAST_448 = (("W4", 449, 0.0), ("W5", 640, 0.0), ("W6", 1024, 0.0))
PAST_448_BATCH = 1024
# The share of rows done at entry of a second block timed at W5.
PAST_448_DONE = 0.9
# The resident trainer: chunks of RESIDENT_K steps held against single
# steps; chunk time also at the JAX default of 50 steps.
RESIDENT_K = 10
RESIDENT_K_DEFAULT = 50
# Steps of the two-layer decoder's graphed chunk (its step unroll issues
# about 25 times the launches of the fused step).
TWO_LAYER_K = 4
# The multi-seed campaign: the seeds of scripts/all_experiments.sh, fresh
# from each seed's init, MULTISEED_STEPS steps in graphed chunks of
# MULTISEED_K, a dev evaluation after each chunk.
MULTISEED_SEEDS = (66, 49, 50)
MULTISEED_K = 10
MULTISEED_STEPS = 20
# Data parallelism: the examples of the two-rank predict.json.
DP_PREDICT_EXAMPLES = 512
# The dataset engine: examples generated, GECA additions at most, and
# predictions visualized.
ENGINE_EXAMPLES = 2000
ENGINE_GECA = 200
ENGINE_VISUALIZED = 16

# NVIDIA H100 SXM data sheet, full 700 W power limit: float32 outside the
# tensor cores, and HBM3 bandwidth. A bound is the larger of operations over
# the first and bytes over the second.
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def require(condition, message):
    if not condition:
        raise SmokeFailure(message)


@contextlib.contextmanager
def phase(name):
    start = time.perf_counter()
    print("== {}".format(name), flush=True)
    yield
    print("== {}: {:.2f} s".format(name, time.perf_counter() - start),
          flush=True)


def nvidia_smi_line():
    result = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return result.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats, warmup=2):
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def graph_ms(fn, repeats):
    """Mean milliseconds of ``fn()`` replayed from a CUDA graph: the
    device's time for its launches, without the host's cost of issuing
    them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def bound_ms(num_bytes, flops):
    """(least milliseconds the card needs, what bounds it)."""
    by_bytes = num_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def attention_work(batch, m, h, masked, key_bytes=4, small_bytes=4):
    """(bytes, flops) of one additive attention call: each input read once
    (the keys at ``key_bytes`` an element, the queries, mask and energy
    vector at ``small_bytes``), each float32 output written once; per (row,
    key, feature) an add, a tanh and a multiply-add for the score and a
    multiply-add for the context."""
    read = (key_bytes * batch * m * h
            + small_bytes * (batch * h + (batch * m if masked else 0) + h))
    written = 4 * (batch * h + batch * m)
    flops = batch * m * h * 6 + batch * m * 5
    return read + written, flops


def decode_block_work(batch, m_t, m_v, h, vocab, steps, weights_bytes,
                      row_steps):
    """(bytes, flops) of one decode-block launch. Bytes: the keys, mask and
    state read once, the weights once, the state and per-step outputs written
    once. Flops: what the ``row_steps`` emitting row-steps of this launch
    need (a done row's step needs nothing)."""
    read = 4 * (batch * m_t * h + batch * m_t + batch * m_v * h
                + 2 * batch * h + batch) + batch + weights_bytes
    written = (4 * (2 * batch * h + batch + steps * batch * (2 + m_t + m_v))
               + batch)
    products = (h * h + 2 * h * h + h * h + 3 * h * 4 * h + h * 4 * h
                + 4 * h * h + h * vocab)
    per_row_step = 2 * products + (m_t + m_v) * (h * 6 + 5) + 12 * h
    return read + written, row_steps * per_row_step


def divergences(tokens, emitted, ref_tokens, ref_emitted, ref_gap):
    """Rows ([B, S] inputs) whose emitted tokens differ from the plain
    version's, as (row, first differing step, the plain version's top-2
    logit gap at that step)."""
    import torch
    emitted, ref_emitted = emitted > 0, ref_emitted > 0
    differ = ((tokens * emitted) != (ref_tokens * ref_emitted)) \
        | (emitted != ref_emitted)
    found = []
    for row in torch.nonzero(differ.any(dim=1)).flatten().tolist():
        step = int(torch.nonzero(differ[row]).flatten()[0])
        found.append((row, step, float(ref_gap[row, step])))
    return found


def decode_divergences(out, ref, rows):
    """``divergences`` of a greedy decode against the first ``rows`` rows of
    the plain (``block_plain``) decode."""
    return divergences(out.tokens, out.emitted_mask, ref.tokens[:rows],
                       ref.emitted_mask[:rows], ref.top2_gap[:rows])


def check_divergences(label, divergences):
    ties = [d for d in divergences if d[2] < NEAR_TIE]
    faults = [d for d in divergences if d[2] >= NEAR_TIE]
    print("{}: {} rows differ from the plain path, {} at argmax near-ties "
          "(row, step, top-2 gap): {}".format(label, len(divergences),
                                              len(ties), ties[:20]))
    require(not faults, "{}: tokens differ from the plain path away from a "
            "near-tie (row, step, gap): {}".format(label, faults[:20]))
    return len(ties)


def as_float64(args):
    """The same arguments with every float tensor in float64."""
    import torch
    out = []
    for arg in args:
        if isinstance(arg, tuple):
            out.append(type(arg)(*as_float64(arg)))
        elif isinstance(arg, torch.Tensor) and arg.is_floating_point():
            out.append(arg.double())
        else:
            out.append(arg)
    return out


def against_float64(label, kernel, plain, exact):
    """Hold the kernel and the plain float32 version to a float64 evaluation
    of the same function: on the fixture's inputs (visual scores reach ~36)
    float32 rounding alone moves the plain version by about the JAX tests'
    absolute bars, so the kernel must be no further from the float64 value
    than twice the plain version's distance, or within 1e-6."""
    kernel_err = float((kernel.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    print("{}: max |err| vs float64: kernel {:.3e}, plain {:.3e}; kernel vs "
          "plain {:.3e}".format(label, kernel_err, plain_err,
                                float((kernel - plain).abs().max())))
    require(kernel_err <= max(2 * plain_err, 1e-6),
            "{}: the kernel is further from float64 than the plain "
            "version".format(label))


def error_ratio(kernel, plain, exact):
    """(the kernel's max |err| against float64, the plain version's, their
    ratio); in the ratio each error counts as at least one float32 ulp of
    the largest float64 value, so two errors at rounding level compare
    even."""
    floor = 1.2e-7 * float(exact.abs().max())
    kernel_err = float((kernel.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    return kernel_err, plain_err, max(kernel_err, floor) / max(plain_err,
                                                                 floor)


def hold_witnesses(label, errors):
    """Hold the kernel to be no further from float64 than the plain
    version over several witnesses (inputs): for each quantity, the
    geometric mean over the witnesses of the kernel's max |err| over the
    plain version's must be at most 2, the bar of ``against_float64``. One
    witness is one draw: over the 56 chained steps of a trained decoder fed
    pad tokens, float32 rounding grows by orders of magnitude in either
    version, and which one lands closer to float64 varies from draw to
    draw."""
    for name, rows in errors.items():
        ratios = [ratio for _, _, ratio in rows]
        mean = math.exp(sum(math.log(r) for r in ratios) / len(ratios))
        print("{} {}: kernel / plain max |err| vs float64 over {} witnesses: "
              "geometric mean {:.3f} (bar 2), min {:.3f}, max {:.3f}, kernel "
              "closer in {}; largest |err| kernel {:.3e}, plain {:.3e}".format(
                  label, name, len(rows), mean, min(ratios), max(ratios),
                  sum(k <= p for k, p, _ in rows),
                  max(k for k, _, _ in rows), max(p for _, p, _ in rows)))
        require(mean <= 2.0, "{} {}: the kernel is further from float64 "
                "than the plain version".format(label, name))


@contextlib.contextmanager
def encoder_precision(seen):
    """Inside the block, record the TF32 flags (matmul, cuDNN) in ``seen``
    at every call of the model's encoder, the first PyTorch products of
    every entry point."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.decode import greedy
    from multimodal_seq2seq_gscan_tpu_torch.models import model
    originals = [(module, module.encode_input) for module in (model, greedy)]

    def recording(inner):
        def encode_input(*args, **kwargs):
            seen.add((torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32))
            return inner(*args, **kwargs)
        return encode_input

    for module, fn in originals:
        module.encode_input = recording(fn)
    try:
        yield
    finally:
        for module, fn in originals:
            module.encode_input = fn


def device_window(fn, sync):
    """(wall ms, device kernel events, device busy ms) of ``fn()``, run once
    before, under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - start) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall_ms, events, sum(e.self_device_time_total
                                for e in events) / 1e3


def profile_train_step(step, sync, repeats=3):
    """Device busy share of ``repeats`` steps and the kernels that take the
    most device time, by torch.profiler; says so if it sees no device
    time."""
    wall_ms, events, device_ms = device_window(
        lambda: [step() for _ in range(repeats)], sync)
    if device_ms <= 0:
        print("profile: torch.profiler saw no device time (not measured)")
        return
    print("profile of {} fused train steps: wall {:.3f} ms, device busy "
          "{:.3f} ms ({:.1f}%), {} device kernels per step".format(
              repeats, wall_ms, device_ms, 100 * device_ms / wall_ms,
              sum(e.count for e in events) // repeats))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print("  {:>9.3f} ms/step  x{:<4d} {}".format(
            e.self_device_time_total / 1e3 / repeats, e.count // repeats,
            e.key[:90]))


def profile_decode(decode, encode, sync):
    """Device busy share of one greedy decode, by torch.profiler, and where
    its device time goes: kernel 2, the encoder (``encode``, profiled
    alone) and the rest; says so if it sees no device time."""
    wall_ms, events, device_ms = device_window(decode, sync)
    if device_ms <= 0:
        print("profile: torch.profiler saw no device time (not measured)")
        return
    block_ms = sum(e.self_device_time_total for e in events
                   if "decode_block_kernel" in e.key) / 1e3
    encoder_ms = device_window(encode, sync)[2]
    print("profile of one block decode: wall {:.3f} ms, device busy {:.3f} "
          "ms ({:.1f}%), {} device kernels; device time: kernel 2 {:.3f} "
          "ms, the encoder {:.3f} ms (profiled alone), the rest {:.3f} "
          "ms".format(wall_ms, device_ms, 100 * device_ms / wall_ms,
                      sum(e.count for e in events), block_ms, encoder_ms,
                      device_ms - block_ms - encoder_ms))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print("  {:>9.3f} ms  x{:<4d} {}".format(
            e.self_device_time_total / 1e3, e.count, e.key[:90]))


def random_attention_inputs(gen, device, batch, m, h, masked):
    """The JAX attention test's input distribution at the given shape:
    N(0, 1) queries and keys, an N(0, 1/H) energy vector, valid lengths
    uniform in 0..M (0 gives an all-masked row)."""
    import torch
    pq = torch.randn(batch, h, generator=gen, device=device)
    keys = torch.randn(batch, m, h, generator=gen, device=device)
    energy = torch.randn(h, 1, generator=gen, device=device) / h ** 0.5
    mask = None
    if masked:
        lengths = torch.randint(0, m + 1, (batch,), generator=gen,
                                device=device)
        mask = (torch.arange(m, device=device)[None] < lengths[:, None]
                ).float()
    return pq, keys, mask, energy


def random_block_inputs(gen, device, batch, m_t, m_v, h, vocab, sos,
                        done_fraction=0.0):
    """Decode-block inputs at the given shape: decoder weights drawn as the
    JAX package initialises them (uniform in +-1/sqrt(fan_in), LSTM
    +-1/sqrt(H), embedding N(0, 1) with the pad row zeroed), N(0, 1) keys,
    command lengths uniform in 1..M_t, h = c = tanh(N(0, 1)), all at SOS;
    each row done at entry with probability ``done_fraction``."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.ops.decode_block import (
        DecoderWeights)

    def uniform(shape, fan_in):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) \
            * fan_in ** -0.5

    embedding = torch.randn(vocab, h, generator=gen, device=device)
    embedding[0] = 0.0
    weights = DecoderWeights(
        txt_qw=uniform((h, h), h), txt_ew=uniform((h, 1), h),
        q2k_w=uniform((2 * h, h), 2 * h), q2k_b=uniform((1, h), 2 * h),
        vis_qw=uniform((h, h), h), vis_ew=uniform((h, 1), h),
        embedding=embedding, w_ih=uniform((3 * h, 4 * h), h),
        w_hh=uniform((h, 4 * h), h),
        bias=uniform((1, 4 * h), h) + uniform((1, 4 * h), h),
        out_w=uniform((4 * h, h), 4 * h), out_proj=uniform((h, vocab), h))
    lengths = torch.randint(1, m_t + 1, (batch,), generator=gen,
                            device=device)
    mask = (torch.arange(m_t, device=device)[None] < lengths[:, None]).float()
    h0 = torch.tanh(torch.randn(batch, h, generator=gen, device=device))
    args = (torch.randn(batch, m_t, h, generator=gen, device=device), mask,
            torch.randn(batch, m_v, h, generator=gen, device=device), h0,
            h0.clone(),
            torch.full((batch,), sos, dtype=torch.int32, device=device))
    done = torch.zeros((batch,), dtype=torch.bool, device=device)
    if done_fraction > 0:
        done = torch.rand(batch, generator=gen, device=device) < done_fraction
    return args + (done, weights)


def fixture_blocks(params, config, batch):
    """The fixture's two decode blocks as kernel 2 takes them, the arguments
    of ``fused_decode_block``: block 1 from SOS, and block 2 from the plain
    version's state after block 1 (most rows done at entry)."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.models import model
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    device = batch.input_ids.device
    with torch.no_grad():
        encoded = model.encode_input(params, config, batch.input_ids,
                                     batch.input_lengths, batch.situations)
        proj_txt, proj_vis = (x.contiguous() for x in
                              model.project_keys(params, encoded))
        h0, c0 = (s[0].contiguous() for s in model.initialize_decoder_hidden(
            params, config, encoded.hidden))
        weights = k2.pack_decoder_weights(params, config.target_pad_idx)
        rows = proj_txt.shape[0]
        first = (proj_txt, encoded.command_mask.contiguous(), proj_vis, h0,
                 c0, torch.full((rows,), config.target_sos_idx,
                                dtype=torch.int32, device=device),
                 torch.zeros((rows,), dtype=torch.bool, device=device),
                 weights)
        state = k2.decode_block_plain(*first, num_steps=EXIT_CHECK_EVERY,
                                      eos_idx=config.target_eos_idx)
    return first, first[:3] + tuple(state[:4]) + (weights,)


def block_pair(label, args, eos_idx):
    """One K-step block through the kernel and through the plain version.
    Tokens, emitted flags, carried tokens and done must agree on every row,
    apart from rows that part at an argmax near-tie of the plain version.
    Returns (kernel output, plain output, rows that did not part)."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    out = k2.fused_decode_block(*args, num_steps=EXIT_CHECK_EVERY,
                                eos_idx=eos_idx)
    if out.h.is_cuda:
        torch.cuda.synchronize()
    gaps = []
    ref = k2.decode_block_plain(*args, num_steps=EXIT_CHECK_EVERY,
                                eos_idx=eos_idx, top2_gap=gaps)
    found = divergences(out.step_tokens.T, out.step_emitted.T,
                        ref.step_tokens.T, ref.step_emitted.T,
                        torch.stack(gaps).T)
    check_divergences("{} K={}".format(label, EXIT_CHECK_EVERY), found)
    same = torch.ones_like(out.done)
    same[[row for row, _, _ in found]] = False
    require(torch.equal(out.done[same], ref.done[same])
            and torch.equal(out.tokens[same], ref.tokens[same]),
            "{}: carried tokens or done differ".format(label))
    return out, ref, same


def rows_of(output, name, rows):
    """Field ``name`` of a block output, restricted to batch ``rows``."""
    value = getattr(output, name)
    return value[:, rows] if name.startswith("step_") else value[rows]


def exact_match(output, dataset, indices, eos_idx):
    from multimodal_seq2seq_gscan_tpu_torch.decode.greedy import (
        strip_output_sequences)
    sequences, _ = strip_output_sequences(output, eos_idx)
    matched = sum(seq == dataset.target_ids[int(i)][1:-1].tolist()
                  for seq, i in zip(sequences, indices))
    return 100.0 * matched / len(indices)


def teacher_forced_work(batch, steps, m_t, m_v, h, e, vocab):
    """(bytes, flops) of kernel 3, of kernel 4 and of the weight-gradient
    helper at these shapes: each input read once, each output written once;
    every row-step runs (teacher forcing has no early exit). A row-step of
    the forward is the decoder step's products, attention terms and cell;
    kernel 4 recomputes it and adds the transposed products, about 10 flops
    per (key, feature) of attention backward and the cell's backward."""
    weights = (h * h + h + 2 * h * h + h + h * h + h + vocab * e
               + (e + 2 * h) * 4 * h + h * 4 * h + 4 * h + (e + 3 * h) * h
               + h * vocab)
    fwd_products = (h * h + 2 * h * h + h * h + (e + 2 * h) * 4 * h
                    + h * 4 * h + (e + 3 * h) * h + h * vocab)
    fwd = 2 * fwd_products + (m_t + m_v) * (6 * h + 5) + 12 * h
    bwd_products = (vocab * h + h * (e + 3 * h) + 4 * h * (e + 2 * h)
                    + 4 * h * h + h * h + 2 * h * h + h * h)
    bwd = fwd + 2 * bwd_products + (m_t + m_v) * (10 * h + 4) + 30 * h
    n = batch * steps
    keys = batch * (m_t * h + m_t + m_v * h)
    width = vocab + 2 * e + 15 * h
    forward = (4 * (n + n * e + keys + 2 * batch * h + n * vocab + 2 * n * h
                    + batch * m_v + weights), n * fwd)
    backward = (4 * (n + n * e + keys + 2 * n * h + n * vocab + batch * m_v
                     + 2 * weights + batch * (m_t + m_v) * h + 2 * batch * h
                     + n * width), n * bwd)
    helper = (4 * (n * width + n * h + n * vocab + weights), 2 * n * weights)
    return forward, backward, helper


GRAD_NAMES = ("proj_txt", "proj_vis", "h0", "c0", "txt_qw", "txt_ew",
              "q2k_w", "q2k_b", "vis_qw", "vis_ew", "embedding", "w_ih",
              "w_hh", "bias", "out_w", "out_proj")


def random_teacher_forced_inputs(gen, device, batch, steps, num_steps, m_t,
                                 m_v, h, vocab, sos):
    """Inputs of the teacher-forced kernels drawn as the JAX tests draw
    them, at the given shapes: ``random_block_inputs``'s weights, keys and
    state (c0 = h0), uniform teacher tokens with pad past ``num_steps``, a
    p = 0.3 dropout mask; and N(0, 1) cotangents of the logits (zero past
    ``num_steps``, as for sliced-off steps) and of the summed attention."""
    import torch
    args = random_block_inputs(gen, device, batch, m_t, m_v, h, vocab, sos)
    tokens = torch.randint(0, vocab, (steps, batch), generator=gen,
                           device=device, dtype=torch.int32)
    tokens[num_steps:] = 0
    drop = (torch.rand(steps, batch, h, generator=gen, device=device)
            > 0.3).float() / 0.7
    dlogits = torch.randn(steps, batch, vocab, generator=gen, device=device)
    dlogits[num_steps:] = 0.0
    g_asum = torch.randn(batch, m_v, generator=gen, device=device)
    return args[:5] + (tokens, drop, args[7]), (dlogits, g_asum)


def helper_library_operands(stash, h_res, dlogits, emb_dim):
    """The helper's 14 products ``X^T dY`` as (X, dY) pairs, each operand
    copied out contiguous before any timing. A sum over row-steps (a bias,
    an energy vector) is the product with a column of ones."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    hidden, vocab = h_res.shape[-1], dlogits.shape[-1]
    lay = tf.stash_layout(vocab, emb_dim, hidden)
    x = stash.reshape(-1, lay.width)
    h = h_res.reshape(-1, hidden)
    ones = torch.ones_like(h[:, :1])

    def cols(start, end):
        return x[:, start:end]

    djp, dg = cols(lay.d_joint, lay.d_pq_txt), cols(lay.d_gates,
                                                    lay.d_pq_vis)
    pairs = [(h, cols(lay.d_pq_txt, lay.d_emb)),
             (ones, cols(lay.g_txt_ew, lay.width)),
             (h, djp), (cols(lay.ctx_cmd, lay.ctx_sit), djp), (ones, djp),
             (cols(lay.vq, lay.d_ph), cols(lay.d_pq_vis, lay.d_joint)),
             (ones, cols(lay.g_vis_ew, lay.g_txt_ew)),
             (cols(lay.onehot, lay.onehot + vocab),
              cols(lay.d_emb, lay.g_vis_ew)),
             (cols(lay.emb, lay.h_new), dg), (cols(lay.ctx_cmd, lay.ph), dg),
             (h, dg), (ones, dg),
             (cols(lay.emb, lay.ph), cols(lay.d_ph, lay.d_gates)),
             (cols(lay.ph, lay.vq), dlogits.reshape(-1, vocab))]
    return [(a.contiguous(), b.contiguous()) for a, b in pairs]


def helper_library(operands):
    """The helper's library call: its 14 products as ``torch.matmul``
    (cuBLAS), assembled into the twelve gradients of ``DecoderWeights``."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.ops.decode_block import (
        DecoderWeights)
    p = [torch.matmul(a.T, b) for a, b in operands]
    return DecoderWeights(p[0], p[1].T, torch.cat([p[2], p[3]]), p[4], p[5],
                          p[6].T, p[7], torch.cat([p[8], p[9]]), p[10],
                          p[11], p[12], p[13])


def kernel_unroll(inputs, dlogits, g_asum, num_steps):
    """Kernel 3, kernel 4 and the helper: ((logits, asum), the 16 gradients
    of GRAD_NAMES, (kernel 4's outputs, h_res, c_res))."""
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    proj_txt, mask, proj_vis, _, _, tokens, drop, weights = inputs
    logits, h_res, c_res, asum = tf.teacher_forced_forward(
        *inputs, num_steps=num_steps)
    raw = tf.teacher_forced_backward(
        proj_txt, mask, proj_vis, tokens, drop, weights, h_res, c_res,
        dlogits, g_asum, num_steps=num_steps)
    grads = tf.teacher_forced_weight_grads(raw[4], h_res, dlogits)
    return (logits, asum), list(raw[:4]) + list(grads), (raw, h_res, c_res)


def plain_unroll(inputs, dlogits, g_asum, num_steps):
    """The plain unroll and its autograd gradients (GRAD_NAMES order)."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    from multimodal_seq2seq_gscan_tpu_torch.ops.decode_block import (
        DecoderWeights)
    proj_txt, mask, proj_vis, h0, c0, tokens, drop, weights = inputs
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (proj_txt, proj_vis, h0, c0, *weights)]
    with torch.enable_grad():
        logits, asum = tf.teacher_forced_plain(
            leaves[0], mask, leaves[1], leaves[2], leaves[3], tokens, drop,
            DecoderWeights(*leaves[4:]), num_steps=num_steps)
        grads = torch.autograd.grad(
            (logits * dlogits).sum() + (asum * g_asum).sum(), leaves)
    return (logits.detach(), asum.detach()), list(grads)


def hold_attention(label, args):
    """Kernel 1 against its plain version (context atol 1e-5, weights atol
    1e-6) and against float64; returns the larger max |err|."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.ops import additive_attention as k1
    kernel = k1.additive_attention(*args)
    torch.cuda.synchronize()
    plain = k1.additive_attention_plain(*args)
    exact = k1.additive_attention_plain(*as_float64(args))
    err = 0.0
    for name, got, want, truth, atol in zip(("context", "weights"), kernel,
                                            plain, exact, (1e-5, 1e-6)):
        against_float64("{} {}".format(label, name), got, want, truth)
        err = max(err, check_close("{} {}".format(label, name), got, want,
                                   0.0, atol))
    return err


def hold_decode_block(label, args, eos_idx, bars=True, state_bars=True):
    """One K=32 block of kernel 2 against its plain version (tokens equal
    apart from near-ties; with ``bars``, attention, and with
    ``state_bars`` also h and c, rtol 1e-5 / atol 1e-6) and, on the rows
    where float64 takes the same tokens, against float64. Returns (the
    largest error against the plain version, the emitting row-steps of
    the block)."""
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    out, ref, same = block_pair(label, args, eos_idx)
    exact = k2.decode_block_plain(*as_float64(args),
                                  num_steps=EXIT_CHECK_EVERY, eos_idx=eos_idx)
    agree = same & (exact.step_tokens == ref.step_tokens).all(dim=0)
    err = 0.0
    for name in ("step_attn_cmd", "step_attn_sit", "h", "c"):
        got, want = rows_of(out, name, same), rows_of(ref, name, same)
        if bars and (state_bars or name.startswith("step_")):
            err = max(err, check_close("{} {}".format(label, name), got,
                                       want, 1e-5, 1e-6))
        against_float64("{} {}".format(label, name),
                        rows_of(out, name, agree), rows_of(ref, name, agree),
                        rows_of(exact, name, agree))
    return err, int(ref.step_emitted.sum())


def hold_teacher_forced(label, inputs, dlogits, g_asum, num_steps):
    """Kernel 3, kernel 4 and the helper on random inputs against the plain
    unroll and its autograd gradients at the JAX tests' bars (logits 1e-5,
    summed attention atol 1e-6, gradients rtol 2e-4 / atol 2e-5), and
    against a float64 evaluation of the plain version (no further than twice
    the plain version's distance); the helper also against its plain
    version; each kernel run twice, every bit the same. Returns the largest
    error of the forward, of kernel 4 and of the helper."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    (logits, asum), grads, (raw, h_res, c_res) = kernel_unroll(
        inputs, dlogits, g_asum, num_steps)
    torch.cuda.synchronize()
    (ref_logits, ref_asum), ref_grads = plain_unroll(inputs, dlogits, g_asum,
                                                     num_steps)
    # The float64 referee: the plain version evaluated in float64 on the
    # same inputs. At these shapes the plain version's own float32 rounding
    # is about the atol of the checks below, so each kernel output is also
    # held to be no further from float64 than twice the plain version's
    # distance.
    (exact_logits, exact_asum), exact_grads = plain_unroll(
        as_float64(inputs), *as_float64((dlogits, g_asum)), num_steps)
    for name, got, want, truth in zip(
            ["logits", "summed attention"] + ["d" + n for n in GRAD_NAMES],
            [logits[:num_steps], asum] + grads,
            [ref_logits[:num_steps], ref_asum] + ref_grads,
            [exact_logits[:num_steps], exact_asum] + exact_grads):
        against_float64("{} {}".format(label, name), got, want, truth)
    del exact_grads
    err = {"forward": max(
        check_close(label + " logits", logits[:num_steps],
                    ref_logits[:num_steps], 1e-5, 1e-5),
        check_close(label + " summed attention", asum, ref_asum, 1e-5, 1e-6)),
        "backward": 0.0, "helper": 0.0}
    for i, (name, got, want) in enumerate(zip(GRAD_NAMES, grads,
                                              ref_grads)):
        key = "backward" if i < 4 else "helper"
        err[key] = max(err[key], check_close(
            "{} d{}".format(label, name), got, want, 2e-4, 2e-5))
    helper_plain = tf.weight_grads_plain(raw[4], h_res, dlogits)
    for name, got, want in zip(GRAD_NAMES[4:], grads[4:], helper_plain):
        check_close("{} helper vs its plain version d{}".format(label, name),
                    got, want, 2e-4, 2e-5)
    again_out, again_grads, (again_raw, again_h, again_c) = kernel_unroll(
        inputs, dlogits, g_asum, num_steps)
    torch.cuda.synchronize()
    forward_same = all(torch.equal(a, b) for a, b in zip(
        [logits, asum, h_res, c_res], list(again_out) + [again_h, again_c]))
    backward_same = all(torch.equal(a, b) for a, b in
                        zip(list(raw) + grads, list(again_raw) + again_grads))
    print("{}: run twice, bit-identical: kernel 3 {}, kernel 4 + helper "
          "{}".format(label, forward_same, backward_same))
    require(forward_same and backward_same,
            "{}: a teacher-forced kernel is not bit-identical from run to "
            "run".format(label))
    return err


def teacher_forced_times(gen, device, label, h, m_t, m_v, vocab, sos_idx,
                         helper):
    """Kernels 3 and 4 (and, with ``helper``, the weight-gradient helper
    beside its library call) at the training shapes (B = TRAIN_BATCH, T =
    TRAIN_T, H = E = h): (kernel, ms, plain ms, bound, plan[, library ms])
    rows for ``time_rows``."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.ops import _build
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    index = _build.device_index(device)
    inputs, (dlogits, g_asum) = random_teacher_forced_inputs(
        gen, device, TRAIN_BATCH, TRAIN_T, TRAIN_T - 3, m_t, m_v, h, vocab,
        sos_idx)
    num_steps = TRAIN_T - 3
    _, h_res, c_res, _ = tf.teacher_forced_forward(*inputs,
                                                   num_steps=num_steps)
    stash = tf.teacher_forced_backward(
        *inputs[:3], *inputs[5:], h_res, c_res, dlogits, g_asum,
        num_steps=num_steps)[4]
    work = teacher_forced_work(TRAIN_BATCH, TRAIN_T, m_t, m_v, h, h, vocab)
    plans = {kernel: tf.shared_memory_plan(kernel, m_t, m_v, h, h, vocab,
                                           index)
             for kernel in tf.KERNEL_NUMBERS}
    times = [
        ("teacher_forced_forward", cuda_ms(
            lambda: tf.teacher_forced_forward(*inputs, num_steps=num_steps),
            10),
         cuda_ms(lambda: tf.teacher_forced_forward_plain(
             *inputs, num_steps=num_steps), 1, warmup=1),
         bound_ms(*work[0]), plans["teacher_forced_forward"]),
        ("teacher_forced_backward", cuda_ms(
            lambda: tf.teacher_forced_backward(
                *inputs[:3], *inputs[5:], h_res, c_res, dlogits, g_asum,
                num_steps=num_steps), 10),
         cuda_ms(lambda: tf.teacher_forced_backward_plain(
             *inputs[:3], *inputs[5:], h_res, c_res, dlogits, g_asum,
             num_steps=num_steps), 1, warmup=1),
         bound_ms(*work[1]), plans["teacher_forced_backward"])]
    if helper:
        # The helper's library call, timed with the helper as CUDA graphs
        # (as on the main path). Its sums of B x T row-steps run in
        # another order than the helper's, so both are held to the same
        # products in float64: the library call within twice the helper's
        # error, or within the helper's bars.
        operands = helper_library_operands(stash, h_res, dlogits,
                                           inputs[7].embedding.shape[1])
        exact = helper_library([(a.double(), b.double())
                                for a, b in operands])
        for grad, got, want, ref in zip(
                GRAD_NAMES[4:], helper_library(operands),
                tf.teacher_forced_weight_grads(stash, h_res, dlogits),
                exact):
            library_err = float((got.double() - ref).abs().max())
            helper_err = float((want.double() - ref).abs().max())
            require(library_err <= max(2 * helper_err, 2e-5 + 2e-4 * float(
                ref.abs().max())), "{} helper library call d{}: max |err| "
                "vs float64 {:.3e}, the helper's {:.3e}".format(
                    label, grad, library_err, helper_err))
        del exact
        library_ms = graph_ms(lambda: helper_library(operands), 10)
        helper_graph_ms = graph_ms(lambda: tf.teacher_forced_weight_grads(
            stash, h_res, dlogits), 10)
        del operands
        times.append(
            ("teacher_forced_weight_grads", cuda_ms(
                lambda: tf.teacher_forced_weight_grads(stash, h_res,
                                                       dlogits), 10),
             cuda_ms(lambda: tf.weight_grads_plain(stash, h_res, dlogits),
                     3),
             bound_ms(*work[2]),
             "from a CUDA graph {:.4f} ms; its library call (14 "
             "torch.matmul) from a CUDA graph {:.4f} ms".format(
                 helper_graph_ms, library_ms), library_ms))
    del inputs, dlogits, g_asum, h_res, c_res, stash
    torch.cuda.empty_cache()
    return times


def time_rows(name, label, times):
    """Prints each (kernel, ms, plain ms, bound, plan[, ...]) row of a
    shape and returns them as the wide rows of the kernels line."""
    rows = []
    for kernel, ms, plain_ms, bound, plan, *_ in times:
        plan_text = plan if isinstance(plan, str) else "plan {} ({}, " \
            "{} bytes per CTA)".format(*plan)
        print("{} {}: {:.4f} ms, plain {:.4f} ms, bound {:.4f} ms "
              "({}); {}".format(label, kernel, ms, plain_ms, *bound,
                                plan_text))
        rows.append(dict(shape=name, kernel=kernel, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound[0],
                         bound_by=bound[1], plan=plan_text))
    return rows


def wide_teacher_forced_rows(gen, device, vocab, sos_idx):
    """Kernels 3, 4 and the helper at WIDE_TEACHER_FORCED (M_t = 16, M_v =
    36, past every cluster plan): held to the plain unroll and to float64
    at T = WIDE_T (``hold_teacher_forced``, each run twice bit for bit),
    the grid plan required on an H100; then kernels 3 and 4 timed at the
    training shapes beside their plain versions and bounds
    (``teacher_forced_times``). Returns one row per kernel and shape."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.ops import _build
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    rows = []
    index = _build.device_index(device)
    m_t, m_v = 16, 36
    h100 = torch.cuda.get_device_name(device).startswith("NVIDIA H100")
    for name, h in WIDE_TEACHER_FORCED:
        label = "wide {} (H=E={}, M_t={}, M_v={}, B={})".format(
            name, h, m_t, m_v, TRAIN_BATCH)
        for kernel in tf.KERNEL_NUMBERS:
            plan = tf.shared_memory_plan(kernel, m_t, m_v, h, h, vocab,
                                         index)
            require(plan[1].startswith("grid") or not h100,
                    "{}: {} takes {} on an H100, not its grid plan".format(
                        label, kernel, plan[1]))
        inputs, (dlogits, g_asum) = random_teacher_forced_inputs(
            gen, device, TRAIN_BATCH, WIDE_T, WIDE_T - 3, m_t, m_v, h, vocab,
            sos_idx)
        hold_teacher_forced(label + " teacher_forced T={}".format(WIDE_T),
                            inputs, dlogits, g_asum, WIDE_T - 3)
        del inputs, dlogits, g_asum
        rows += time_rows(name, label, teacher_forced_times(
            gen, device, label, h, m_t, m_v, vocab, sos_idx, helper=False))
    return rows


def wide_shape_rows(gen, device, vocab, sos_idx, eos_idx):
    """Every kernel at WIDE_SHAPES: held to its plain version and to float64
    (hold_attention, hold_decode_block, hold_teacher_forced), then timed
    beside its plain version and its bound, with the shared-memory plan
    kernels 3 and 4 take. Returns one row per kernel and shape."""
    from multimodal_seq2seq_gscan_tpu_torch.ops import _build
    from multimodal_seq2seq_gscan_tpu_torch.ops import additive_attention as k1
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    wide_rows = []
    index = _build.device_index(device)
    for name, h, w_m_t, w_m_v in WIDE_SHAPES:
        label = "wide {} (H=E={}, M_t={}, M_v={})".format(name, h, w_m_t,
                                                          w_m_v)
        calls = [random_attention_inputs(gen, device, BATCH, m, h, masked)
                 for m, masked in ((w_m_t, True), (w_m_v, False))]
        for args in calls:
            hold_attention("{} additive_attention M={}".format(
                label, args[1].shape[1]), args)
        block_args = random_block_inputs(gen, device, BATCH, w_m_t, w_m_v,
                                         h, vocab, sos_idx)
        _, row_steps = hold_decode_block(label + " decode_block", block_args,
                                         eos_idx)
        inputs, (dlogits, g_asum) = random_teacher_forced_inputs(
            gen, device, TRAIN_BATCH, WIDE_T, WIDE_T - 3, w_m_t, w_m_v,
            h, vocab, sos_idx)
        hold_teacher_forced(label + " teacher_forced T={}".format(WIDE_T),
                            inputs, dlogits, g_asum, WIDE_T - 3)
        del inputs, dlogits, g_asum

        # Times: kernels 1 and 2 at the decode's batch, kernels 3, 4 and
        # the helper at the training shapes.
        def both(fn):
            return lambda: [fn(*args) for args in calls]

        weights_bytes = sum(w.numel() * 4 for w in block_args[7])
        times = [
            ("additive_attention",
             cuda_ms(both(k1.additive_attention), 20),
             cuda_ms(both(k1.additive_attention_plain), 3),
             bound_ms(*(sum(x) for x in zip(
                 attention_work(BATCH, w_m_t, h, True),
                 attention_work(BATCH, w_m_v, h, False)))),
             "from a CUDA graph {:.4f} ms".format(
                 graph_ms(both(k1.additive_attention), 20))),
            ("decode_block", cuda_ms(lambda: k2.fused_decode_block(
                *block_args, num_steps=EXIT_CHECK_EVERY,
                eos_idx=eos_idx), 3),
             cuda_ms(lambda: k2.decode_block_plain(
                 *block_args, num_steps=EXIT_CHECK_EVERY,
                 eos_idx=eos_idx), 1, warmup=1),
             bound_ms(*decode_block_work(
                 BATCH, w_m_t, w_m_v, h, vocab, EXIT_CHECK_EVERY,
                 weights_bytes, row_steps)),
             k2.block_plan(h, vocab, w_m_t, w_m_v, index).describe())]
        del calls, block_args
        times += teacher_forced_times(gen, device, label, h, w_m_t, w_m_v,
                                      vocab, sos_idx, helper=True)
        wide_rows += time_rows(name, label, times)
        wide_rows[-1]["library_ms"] = times[-1][5]
    return wide_rows


def past_448_rows(gen, device, vocab, sos_idx, eos_idx):
    """Kernel 2 at PAST_448 (H = 449, 640, 1024; M_t = 16, M_v = 36, random
    weights from SOS), and a second block at W5 with PAST_448_DONE of the
    rows done at entry: held to its plain version at the JAX bars (tokens
    and attention) and to float64 (attention, h and c;
    ``hold_decode_block``), then timed beside its plain version and its
    bound, with the plan it takes (on an H100, the grid plan). Returns one
    row per shape."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.ops import _build
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    rows = []
    index = _build.device_index(device)
    batch, m_t, m_v = PAST_448_BATCH, 16, 36
    h100 = torch.cuda.get_device_name(device).startswith("NVIDIA H100")
    for name, h, done in PAST_448 + (("W5", 640, PAST_448_DONE),):
        label = "wide {} (H=E={}, M_t={}, M_v={}, B={}{})".format(
            name, h, m_t, m_v, batch,
            ", {:.0%} done at entry".format(done) if done else "")
        args = random_block_inputs(gen, device, batch, m_t, m_v, h, vocab,
                                   sos_idx, done_fraction=done)
        plan = k2.block_plan(h, vocab, m_t, m_v, index)
        print("{} decode_block: {}".format(label, plan.describe()))
        require(plan.grid or not h100, "{}: kernel 2 takes {} on an H100, "
                "not its grid plan".format(label, plan.describe()))
        before = k2.launches
        # The JAX bars on the tokens and the attention; h and c, which the
        # plain version itself carries that far from float64 at these
        # widths (printed), are held to float64.
        _, row_steps = hold_decode_block(label + " decode_block", args,
                                         eos_idx, state_bars=False)
        require(k2.launches > before, "{}: kernel 2 was not launched".format(
            label))

        def kernel():
            return k2.fused_decode_block(*args, num_steps=EXIT_CHECK_EVERY,
                                         eos_idx=eos_idx)

        ms = cuda_ms(kernel, 2, warmup=1)
        plain_ms = cuda_ms(lambda: k2.decode_block_plain(
            *args, num_steps=EXIT_CHECK_EVERY, eos_idx=eos_idx), 1,
            warmup=1)
        bound = bound_ms(*decode_block_work(
            batch, m_t, m_v, h, vocab, EXIT_CHECK_EVERY,
            sum(w.numel() * 4 for w in args[7]), row_steps))
        print("{} decode_block: {:.4f} ms, plain {:.4f} ms, bound {:.4f} ms "
              "({}); {}".format(label, ms, plain_ms, *bound,
                                plan.describe()))
        rows.append(dict(shape=name, kernel="decode_block", ms=ms,
                         plain_ms=plain_ms, bound_ms=bound[0],
                         bound_by=bound[1], plan=plan.describe(), batch=batch,
                         done_at_entry=done))
        del args
    return rows


def predict_checks(label, dataset, params, config, decoded, em_decoded,
                   inputs, decode, sync, rows):
    """``predict_and_save`` over the first ``rows`` dev examples at batch
    ``rows`` (kernel 2), into a temporary predict.json: as many records as
    examples, every prediction the decode's tokens (``decoded``), as many
    exact matches as the decode's exact match, each attention row summing
    to 1 within 1e-5, the textual rows as long as the input; ``evaluate``
    of the same examples (kernel 2 again) at that exact match. Prints the
    decode's milliseconds apart from the host's (records, then the JSON
    file), and the file's size."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.decode.greedy import (
        strip_output_sequences)
    from multimodal_seq2seq_gscan_tpu_torch.decode.predict import (
        evaluate, predict, predict_and_save)
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    out_dir = tempfile.mkdtemp(prefix="gscan_chip_smoke_predict_")
    try:
        path = os.path.join(out_dir, "predict.json")
        k2.launches = 0
        start = time.perf_counter()
        predict_and_save(dataset, params, config, path, MAX_DECODING_STEPS,
                         batch_size=rows, max_testing_examples=rows,
                         device=DEVICE)
        save_ms = (time.perf_counter() - start) * 1e3
        launches = k2.launches
        start = time.perf_counter()
        records = list(predict(dataset, params, config, MAX_DECODING_STEPS,
                               batch_size=rows,
                               max_examples_to_evaluate=rows,
                               device=DEVICE))
        records_ms = (time.perf_counter() - start) * 1e3
        k2.launches = 0
        accuracy, em_eval, _ = evaluate(
            dataset, params, config, MAX_DECODING_STEPS, batch_size=rows,
            max_examples_to_evaluate=rows, device=DEVICE)
        launches_eval = k2.launches
        with torch.no_grad():
            decode(params, *inputs)
            sync()
            start = time.perf_counter()
            decode(params, *inputs)
            sync()
            decode_ms = (time.perf_counter() - start) * 1e3
        size = os.path.getsize(path)
        with open(path) as f:
            written = json.load(f)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print("{}: predict.json {} records, {} bytes; kernel 2 launches {} "
          "(evaluate: {})".format(label, len(written), size, launches,
                                  launches_eval))
    print("{}: decode {:.3f} ms (one decode of the {} examples, wall "
          "clock), records on the host {:.3f} ms, JSON file {:.3f} ms "
          "(predict_and_save {:.3f} ms in all)".format(
              label, decode_ms, rows, records_ms - decode_ms,
              save_ms - records_ms, save_ms))
    require(launches > 0 and launches_eval > 0,
            "{}: predict or evaluate did not launch kernel 2".format(label))
    require(len(written) == len(records) == rows,
            "{}: predict.json holds {} records".format(label, len(written)))
    sequences, _ = strip_output_sequences(decoded, config.target_eos_idx)
    words = [dataset.array_to_sentence(seq, "target") for seq in sequences]
    same = sum(record["prediction"] == w for record, w in zip(written,
                                                                words))
    exact = sum(record["exact_match"] for record in written)
    print("{}: predict.json against the decode: {} of {} predictions equal, "
          "exact match {:.4f}% (the decode {:.4f}%, evaluate {:.4f}%, "
          "accuracy {:.4f})".format(label, same, rows, 100.0 * exact / rows,
                                    em_decoded, em_eval, accuracy))
    require(same == rows, "{}: predictions differ from the decode".format(
        label))
    require(100.0 * exact / rows == em_decoded
            and abs(em_eval - em_decoded) <= 1e-9,
            "{}: predict.json's or evaluate's exact match differs from the "
            "decode's".format(label))
    worst, wrong_length = 0.0, 0
    for record in written:
        for row in record["attention_weights_input"]:
            worst = max(worst, abs(sum(row[0]) - 1.0))
            wrong_length += len(row[0]) != len(record["input"]) + 2
        for row in record["attention_weights_situation"]:
            worst = max(worst, abs(sum(row[0]) - 1.0))
    print("{}: predict.json attention rows: largest |sum - 1| {:.3e} (bar "
          "1e-5); textual rows not as long as the input: {}".format(
              label, worst, wrong_length))
    require(worst <= 1e-5 and wrong_length == 0,
            "{}: predict.json's attention rows are not distributions over "
            "the input".format(label))
    return decode_ms


def hold_chunk(label, chunk_state, chunk_metrics, step_state, step_metrics):
    """A chunk's state and metrics against single steps': metrics
    bit-identical or within rtol 2e-5 / atol 1e-6 (JAX's chunk test's
    bars), params and Adam moments within atol 1e-6. Prints the largest
    differences."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.models.params import leaves
    metric_err, metric_same = 0.0, True
    for name, values in chunk_metrics.items():
        want = torch.stack([m[name] for m in step_metrics])
        metric_same &= torch.equal(values, want)
        metric_err = max(metric_err, check_close_quiet(
            values, want, 2e-5, 1e-6, "{} {}".format(label, name)))
    errors = {}
    for tree in ("params", "mu", "nu"):
        get = (lambda s: s.params) if tree == "params" else (
            lambda s, t=tree: getattr(s.opt_state, t))
        errors[tree] = max(check_close_quiet(a, b, 0.0, 1e-6, "{} {}".format(
            label, tree)) for a, b in zip(leaves(get(chunk_state)),
                                          leaves(get(step_state))))
    require(chunk_state.step == step_state.step
            and chunk_state.opt_state[0::3] == step_state.opt_state[0::3],
            "{}: the counts differ".format(label))
    print("{}: losses {}; metrics {} (max |err| {:.3e}); params, mu, nu "
          "max |err| {:.3e}, {:.3e}, {:.3e} (atol 1e-6)".format(
              label, ["{:.6f}".format(float(x))
                      for x in chunk_metrics["loss"]],
              "bit-identical" if metric_same else "not bit-identical",
              metric_err, errors["params"], errors["mu"], errors["nu"]))


def resident_checks(train_set, config, events, streamed_batch, sync):
    """The resident trainer on the card, from the fixture checkpoint
    (step 200000): (a) a graphed chunk of RESIDENT_K steps, full layout,
    against as many eager single steps on the same index rows, dropout on
    (``hold_chunk``); (b) the same for a stratified chunk (cuts (32,)),
    its single steps at their segments' widths; (c) ms per step of the
    graphed chunk (K = RESIDENT_K and RESIDENT_K_DEFAULT) against the
    streamed step and an eager step on the resident batch, with the device
    busy share of each; (d) ``train(steps_per_execution=RESIDENT_K)`` to
    step 200020 with a dev evaluation of STEP_EXAMPLES examples at 200020."""
    import numpy as np
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    from multimodal_seq2seq_gscan_tpu_torch.train import resident
    from multimodal_seq2seq_gscan_tpu_torch.train.checkpoint import (
        load_checkpoint)
    from multimodal_seq2seq_gscan_tpu_torch.train.loop import train
    from multimodal_seq2seq_gscan_tpu_torch.train.state import Adam
    from multimodal_seq2seq_gscan_tpu_torch.train.step import train_step
    optimizer = Adam()
    start, _ = load_checkpoint(str(FIXTURE / "model_best.msgpack"),
                               device=DEVICE)
    data = resident.build_resident_data(train_set, DEVICE)
    host = resident.host_resident_data(train_set)
    print("resident data: {} examples, {} bytes on the card (input {}, "
          "targets {}, grids {} uint8)".format(
              data.num_examples, data.nbytes, tuple(data.input_ids.shape),
              tuple(data.target_ids.shape), tuple(data.situations.shape)))
    chunk = resident.make_train_chunk(config, optimizer)

    def single_steps(block, widths):
        state, metrics = start, []
        for row, width in zip(block, widths):
            batch = resident.gather_batch(data, row)
            batch = batch._replace(target_ids=batch.target_ids[:, :width])
            state, step_metrics = train_step(state, batch, config, optimizer)
            metrics.append(step_metrics)
        return state, metrics

    # (a) The full layout.
    t_full = data.target_ids.shape[1]
    block = next(resident.index_block_stream(
        data.num_examples, TRAIN_BATCH, RESIDENT_K,
        np.random.default_rng(SEED)))
    graphed = chunk(start, data, block)
    hold_chunk("resident chunk, full layout (K={}, T={})".format(
        RESIDENT_K, t_full), *graphed,
        *single_steps(block, [t_full] * RESIDENT_K))
    # (b) The stratified layout.
    s_block, spec = next(resident.stratified_index_block_stream(
        host.target_lengths, TRAIN_BATCH, RESIDENT_K,
        np.random.default_rng(SEED), cuts=(32,)))
    widths = [min(w, t_full) for count, w in spec for _ in range(count)]
    graphed = chunk(start, data, s_block, spec)
    hold_chunk("resident chunk, stratified layout (K={}, segments {})".format(
        RESIDENT_K, spec), *graphed, *single_steps(s_block, widths))
    del graphed

    # (c) Times: per step, by CUDA events, and the device's busy share.
    block_default = next(resident.index_block_stream(
        data.num_examples, TRAIN_BATCH, RESIDENT_K_DEFAULT,
        np.random.default_rng(SEED + 1)))
    resident_batch = resident.gather_batch(data, block[0])
    streamed_batch = streamed_batch.to(DEVICE)
    runs = (
        ("graphed chunk, K={}".format(RESIDENT_K),
         lambda: chunk(start, data, block), RESIDENT_K),
        ("graphed chunk, K={}".format(RESIDENT_K_DEFAULT),
         lambda: chunk(start, data, block_default), RESIDENT_K_DEFAULT),
        ("eager steps on the resident batch (T={})".format(t_full),
         lambda: [train_step(start, resident_batch, config, optimizer)
                  for _ in range(RESIDENT_K)], RESIDENT_K),
        ("streamed steps (T={})".format(streamed_batch.target_ids.shape[1]),
         lambda: [train_step(start, streamed_batch, config, optimizer)
                  for _ in range(RESIDENT_K)], RESIDENT_K))
    for label, fn, steps in runs:
        ms = cuda_ms(fn, 3, warmup=1) / steps
        wall_ms, events, busy_ms = device_window(fn, sync)
        print("{}: {:.3f} ms a step; profiled: wall {:.3f} ms, device busy "
              "{} a step, {} device kernels a step".format(
                  label, ms, wall_ms / steps,
                  "{:.3f} ms ({:.1f}%)".format(busy_ms / steps,
                                               100 * busy_ms / wall_ms)
                  if busy_ms > 0 else "not measured",
                  sum(e.count for e in events) // steps))

    # (d) train() end to end on the resident path.
    out_dir = tempfile.mkdtemp(prefix="gscan_chip_smoke_resident_")
    before = len(events)
    try:
        k2.launches = 0
        tf.launches.update({name: 0 for name in tf.launches})
        state, _ = train(
            str(FIXTURE / "dataset.txt"), str(FIXTURE),
            training_batch_size=TRAIN_BATCH,
            resume_from_file=str(FIXTURE / "model_best.msgpack"),
            max_training_iterations=200020, print_every=RESIDENT_K,
            evaluate_every=2 * RESIDENT_K, output_directory=out_dir,
            max_testing_examples=STEP_EXAMPLES, seed=SEED,
            steps_per_execution=RESIDENT_K, device=DEVICE,
            callback=lambda *event: events.append(event))
        sync()
        launches = dict(tf.launches, decode_block=k2.launches)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    seen = events[before:]
    for kind, iteration, values in seen:
        print("resident train {} {}: {}".format(kind, iteration, ", ".join(
            "{} {:.6g}".format(k, v) for k, v in values.items())))
    print("launches, resident training (kernels 3, 4 and the helper: "
          "warm-up, capture and single steps; replays are not counted): "
          "{}".format(launches))
    require(all(count > 0 for count in launches.values()),
            "a kernel of the resident path was not launched")
    # Logged at every multiple of RESIDENT_K, evaluated at every multiple
    # of 2 RESIDENT_K, from 200000 (the single step before the chunks) on.
    losses = [v["loss"] for kind, _, v in seen if kind == "train"]
    evaluations = [(it, v) for kind, it, v in seen if kind == "eval"]
    require(state.step == 200021
            and len(losses) == len(range(200000, 200021, RESIDENT_K))
            and all(math.isfinite(x) and x < 1.0 for x in losses),
            "resident training: step {}, losses {}".format(state.step,
                                                           losses))
    require([it for it, _ in evaluations]
            == list(range(200000, 200021, 2 * RESIDENT_K))
            and evaluations[-1][1]["exact_match"] > 90.0,
            "resident training's dev evaluations: {}".format(evaluations))
    print("resident training: dev exact match {:.4f}% on {} examples at "
          "{}".format(evaluations[-1][1]["exact_match"], STEP_EXAMPLES,
                      evaluations[-1][0]))


def wide_training_checks(train_set, sync):
    """C.12's witness: the default training path ("fused", kernels 3 and 4
    and the helper) at H = E = WIDE_TRAIN_H, a decoder width no cluster plan
    of kernels 3 and 4 fits (their grid plans, required on an H100), on
    random weights from SEED with a non-zero Adam state at step 7 and the
    fixture's train split on the card: one ``loss_and_grads`` against
    ``teacher_forced_impl="plain"`` (loss rtol 1e-5, gradients rtol 3e-4 /
    atol 3e-5), then a graphed resident chunk of WIDE_TRAIN_K steps against
    as many eager plain steps on the same index rows and dropout (per-step
    loss rtol 1e-5, params atol 1e-6: the JAX bars); its ms a step."""
    import numpy as np
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
    from multimodal_seq2seq_gscan_tpu_torch.models.params import (
        leaves, tree_map)
    from multimodal_seq2seq_gscan_tpu_torch.ops import _build
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    from multimodal_seq2seq_gscan_tpu_torch.train import resident
    from multimodal_seq2seq_gscan_tpu_torch.train.state import (
        Adam, create_train_state)
    from multimodal_seq2seq_gscan_tpu_torch.train.step import (
        loss_and_grads, train_step)
    h = WIDE_TRAIN_H
    config = ModelConfig(
        input_vocabulary_size=train_set.input_vocabulary_size,
        target_vocabulary_size=train_set.target_vocabulary_size,
        num_cnn_channels=train_set.image_channels, encoder_hidden_size=h,
        decoder_hidden_size=h)
    require(config.teacher_forced_impl == "fused",
            "the default teacher_forced_impl is {}".format(
                config.teacher_forced_impl))
    plain_config = config._replace(teacher_forced_impl="plain")
    optimizer = Adam()
    start = create_train_state(SEED, config, optimizer, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    mu = tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                        device=DEVICE) * 1e-3, start.params)
    nu = tree_map(lambda p: torch.rand(p.shape, generator=gen,
                                       device=DEVICE) * 9e-6 + 1e-6,
                  start.params)
    start = start._replace(step=7, opt_state=start.opt_state._replace(
        count=7, mu=mu, nu=nu, schedule_count=7))
    data = resident.build_resident_data(train_set, DEVICE)
    block = next(resident.index_block_stream(
        data.num_examples, TRAIN_BATCH, WIDE_TRAIN_K,
        np.random.default_rng(SEED)))
    m_t = data.input_ids.shape[1]
    m_v = data.situations.shape[1] * data.situations.shape[2]
    index = _build.device_index(torch.device(DEVICE))
    h100 = torch.cuda.get_device_name(0).startswith("NVIDIA H100")
    for kernel in tf.KERNEL_NUMBERS:
        plan = tf.shared_memory_plan(kernel, m_t, m_v, h, h,
                                     config.target_vocabulary_size, index)
        print("H = {}: {} takes {}".format(h, kernel, plan))
        require(plan[1].startswith("grid") or not h100,
                "{} takes {} at H = {} on an H100, not its grid plan".format(
                    kernel, plan[1], h))

    first = resident.gather_batch(data, block[0])
    got, want = (loss_and_grads(start, first, c)
                 for c in (config, plain_config))
    rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    grad_err = max(check_close_quiet(a, b, 3e-4, 3e-5, "H={} step 1".format(
        h)) for a, b in zip(leaves(got[2]), leaves(want[2])))
    print("H = {}, step 1, fused vs plain: loss {:.8f} vs {:.8f} (rel err "
          "{:.3e}, rtol 1e-5); gradients max |err| {:.3e} (rtol 3e-4, atol "
          "3e-5)".format(h, float(got[0]), float(want[0]), rel, grad_err))
    require(rel <= 1e-5, "H = {}: the step-1 loss differs".format(h))
    del got, want

    tf.launches.update({name: 0 for name in tf.launches})
    chunk = resident.make_train_chunk(config, optimizer)
    chunk_state, chunk_metrics = chunk(start, data, block)
    sync()
    launches = dict(tf.launches)
    print("launches, H = {} graphed chunk (warm-up and capture; replays are "
          "not counted): {}".format(h, launches))
    require(all(count > 0 for count in launches.values()),
            "a kernel of the H = {} training path was not launched".format(h))
    state, losses = start, []
    for row in block:
        state, metrics = train_step(state, resident.gather_batch(data, row),
                                    plain_config, optimizer)
        losses.append(float(metrics["loss"]))
    chunk_losses = [float(x) for x in chunk_metrics["loss"]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(chunk_losses, losses))
    param_err = max(float((a - b).abs().max()) for a, b in zip(
        leaves(chunk_state.params), leaves(state.params)))
    print("H = {}, graphed chunk of {} fused steps vs eager plain steps: "
          "losses {} vs {} (max rel err {:.3e}, rtol 1e-5); params max |err| "
          "{:.3e} (atol 1e-6)".format(
              h, WIDE_TRAIN_K, ["{:.6f}".format(x) for x in chunk_losses],
              ["{:.6f}".format(x) for x in losses], rel, param_err))
    require(all(math.isfinite(x) for x in chunk_losses) and rel <= 1e-5,
            "H = {}: the chunk's losses differ from the plain path's".format(
                h))
    require(param_err <= 1e-6, "H = {}: the chunk's params differ from the "
            "plain path's".format(h))
    again = chunk(start, data, block)
    sync()
    require(leaves_equal(again[0].params, chunk_state.params),
            "H = {}: the graphed chunk is not bit-identical on a "
            "replay".format(h))
    ms = cuda_ms(lambda: chunk(start, data, block), 2, warmup=1)
    print("H = {}: graphed chunk {:.3f} ms a step (B={}, T={}); replayed "
          "bit for bit".format(h, ms / WIDE_TRAIN_K, TRAIN_BATCH,
                               data.target_ids.shape[1]))


@contextlib.contextmanager
def patched(module, name, value):
    """While open, ``module.name`` is ``value``."""
    before = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, before)


def chunk_losses(make_chunk, losses):
    """``make_chunk`` (a package's resident chunk maker) whose chunks append
    their per-step losses to ``losses``."""
    def made(*args, **kwargs):
        chunk = make_chunk(*args, **kwargs)

        def run(*chunk_args):
            state, metrics = chunk(*chunk_args)
            losses.extend(float(x) for x in metrics["loss"])
            return state, metrics
        return run
    return made


def wide_plans(config, m_t, m_v):
    """Prints the plan each kernel takes at ``config``'s widths on this
    card; kernel 2 must take its grid plan, kernels 3 and 4 theirs."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    index = torch.cuda.current_device()
    h, e = config.decoder_hidden_size, config.embedding_dimension
    vocab = config.target_vocabulary_size
    block = k2.block_plan(h, vocab, m_t, m_v, index)
    plans = [tf.shared_memory_plan(kernel, m_t, m_v, h, e, vocab, index)[1]
             for kernel in ("teacher_forced_forward",
                            "teacher_forced_backward")]
    print("plans at H = {}, E = {}, M_t = {}, M_v = {}: kernel 2 {}; kernel "
          "3 {}; kernel 4 {}".format(h, e, m_t, m_v, block.describe(),
                                     *plans))
    require(block.grid and all(p.startswith("grid") for p in plans),
            "the kernels do not take their grid plans")


def require_kernels(label, fn, names, sync):
    """Runs ``fn()`` under torch.profiler (after one run outside it) and
    requires a launch of each device kernel in ``names`` (substrings of
    the kernels' names), printing their counts; fails where the profiler
    sees no device time."""
    _, events, busy_ms = device_window(fn, sync)
    require(busy_ms > 0, "{}: torch.profiler saw no device time, so the "
            "kernels run are not observed".format(label))
    seen = {name: sum(e.count for e in events if name in e.key)
            for name in names}
    print("{}: device kernels in the profile: {}".format(label, seen))
    require(all(seen.values()), "{}: a kernel of its plan did not "
            "run".format(label))


def wide_decoder_checks(train_set, dataset, smi, sync):
    """The wide decoder (encoder and decoder H = WIDE_TRAIN_H, the flagship
    architecture otherwise, the fixture's data) through every entry point
    of the port, from WIDE_PRETRAIN graphed steps of SEED's init; the plan
    each kernel takes (kernel 2's grid plan, kernels 3 and 4's, required),
    and at each path launch counts set to 0 before it and read after it,
    and its times: (a) ``train`` resumed for one step and two resident
    chunks of WIDE_TRAIN_K with a dev evaluation of WIDE_EXAMPLES at each
    print, writing model_best, held to the same ``train`` on the plain
    versions (``teacher_forced_impl="plain"``, ``"block_plain"`` decodes:
    per-step loss rtol 1e-5, params atol 1e-6, the evaluations' accuracy
    and exact match atol 1e-6), and 4 streamed steps likewise; one step
    profiled for the grid kernels and the helper's wide tiles; (b) the
    block decode of the first WIDE_EXAMPLES dev examples with that
    model_best: its tokens those of ``"block_plain"`` but at argmax
    near-ties, its attention rtol 1e-5 / atol 1e-6, one decode profiled for
    kernel 2's grid kernel, both blocks of kernel 2 timed; then
    ``predict_checks`` (``predict_and_save`` and ``evaluate``) of those
    examples; (c) the three bf16 decodes (kernel 1's bf16 form), each held
    to the same decode on kernel 1's plain version (``bf16_near_ties``),
    and the float32 step decode (kernel 1) against the plain decode; (d) a
    campaign of WIDE_SEEDS fresh from init, each seed bit for bit its
    single-seed run (C.14); (e) a one-rank NCCL chunk from the pretrained
    state bit for bit the unsharded one, and the sharded decode of (b)'s
    examples bit for bit the unsharded decode (C.14); (f) ``cli_checks``:
    ``--mode=train`` for one chunk, then ``--mode=test`` on its
    model_best."""
    import numpy as np
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.decode import greedy
    from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
    from multimodal_seq2seq_gscan_tpu_torch.models.params import leaves
    from multimodal_seq2seq_gscan_tpu_torch.ops import additive_attention as k1
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    from multimodal_seq2seq_gscan_tpu_torch.train import loop, resident
    from multimodal_seq2seq_gscan_tpu_torch.train.checkpoint import (
        load_params, save_checkpoint)
    from multimodal_seq2seq_gscan_tpu_torch.train.state import Adam
    from multimodal_seq2seq_gscan_tpu_torch.train.step import train_step
    from multimodal_seq2seq_gscan_tpu_torch.utils.precision import (
        full_float32)
    h, k = WIDE_TRAIN_H, WIDE_TRAIN_K
    width = dict(encoder_hidden_size=h, decoder_hidden_size=h)
    config = ModelConfig(
        input_vocabulary_size=train_set.input_vocabulary_size,
        target_vocabulary_size=train_set.target_vocabulary_size,
        num_cnn_channels=train_set.image_channels, **width)
    batch, indices, _, _ = next(dataset.get_data_iterator(
        batch_size=WIDE_EXAMPLES, pad_to_full_batch=True,
        with_representations=False))
    batch = batch.to(DEVICE)
    inputs = (batch.input_ids, batch.input_lengths, batch.situations,
              batch.target_positions)
    m_t = batch.input_ids.shape[1]
    m_v = batch.situations.shape[1] * batch.situations.shape[2]
    eos = config.target_eos_idx
    wide_plans(config, m_t, m_v)
    times = {}

    def zero_counts():
        k1.launches, k1.launches_bf16, k2.launches = 0, 0, 0
        tf.launches.update({name: 0 for name in tf.launches})

    def counts():
        return dict(tf.launches, decode_block=k2.launches,
                    additive_attention=k1.launches)

    def train_kw(**options):
        return dict(dict(training_batch_size=TRAIN_BATCH, seed=SEED,
                         max_testing_examples=WIDE_EXAMPLES,
                         evaluation_batch_size=WIDE_EXAMPLES, device=DEVICE,
                         **width), **options)

    root = Path(tempfile.mkdtemp(prefix="gscan_chip_smoke_wide_"))
    try:
        # Pretraining: no evaluation, so that no best exact match is kept.
        pre_events = []
        begin = time.perf_counter()
        pre_state, _ = loop.train(
            str(FIXTURE / "dataset.txt"), str(FIXTURE),
            **train_kw(max_training_iterations=WIDE_PRETRAIN,
                       print_every=WIDE_PRETRAIN_K,
                       evaluate_every=4 * WIDE_PRETRAIN,
                       steps_per_execution=WIDE_PRETRAIN_K,
                       output_directory=str(root / "pretrain"),
                       callback=lambda *event: pre_events.append(event)))
        sync()
        pre_path = save_checkpoint(str(root / "pretrain"), pre_state)
        print("pretraining at H = {}: {} steps from seed {}'s init in "
              "graphed chunks of {}, {:.2f} s; losses {}".format(
                  h, WIDE_PRETRAIN, SEED, WIDE_PRETRAIN_K,
                  time.perf_counter() - begin,
                  ["{:.5f}".format(v["loss"]) for _, _, v in pre_events]))
        last = WIDE_PRETRAIN + 2 * k

        # (a) train(), resident, against the plain versions.
        runs = {}
        for name, impl, decode_impl in (("kernel", "fused", "block"),
                                        ("plain", "plain", "block_plain")):
            losses, events = [], []
            zero_counts()
            begin = time.perf_counter()
            with patched(loop, "make_train_chunk", chunk_losses(
                    loop.make_train_chunk, losses)), \
                    patched(greedy, "DEFAULT_DECODE_IMPL", decode_impl):
                state, _ = loop.train(
                    str(FIXTURE / "dataset.txt"), str(FIXTURE),
                    **train_kw(resume_from_file=pre_path,
                               max_training_iterations=last, print_every=k,
                               evaluate_every=k, steps_per_execution=k,
                               teacher_forced_impl=impl,
                               output_directory=str(root / ("a_" + name)),
                               callback=lambda *event: events.append(
                                   event)))
            sync()
            runs[name] = (state, [v["loss"] for kind, it, v in events
                                  if kind == "train" and it
                                  == WIDE_PRETRAIN] + losses,
                          events, counts(), time.perf_counter() - begin)
        (state, losses, events, launches, wall), plain = runs["kernel"], \
            runs["plain"]
        print("(a) launches (kernels 3, 4 and the helper: the single step, "
              "warm-up and capture; kernel 2: the evaluations): {}; plain "
              "run {}".format(launches, plain[3]))
        require(all(launches[name] > 0 for name in tf.launches)
                and launches["decode_block"] > 0,
                "(a): a kernel of the path was not launched")
        require(not any(plain[3].values()),
                "(a): the plain run launched a kernel")
        for kind, it, values in events:
            print("(a) {} {}: {}".format(kind, it, ", ".join(
                "{} {:.6g}".format(name, v) for name, v in values.items())))
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain[1]))
        param_err = max(float((a - b).abs().max()) for a, b in zip(
            leaves(state.params), leaves(plain[0].params)))
        print("(a) per-step losses, kernels {} vs plain {}: max rel err "
              "{:.3e} (rtol 1e-5); params max |err| {:.3e} (atol "
              "1e-6)".format(["{:.6f}".format(x) for x in losses],
                             ["{:.6f}".format(x) for x in plain[1]], rel,
                             param_err))
        require(len(losses) == len(plain[1]) == 2 * k + 1
                and all(math.isfinite(x) for x in losses) and rel <= 1e-5,
                "(a): the per-step losses differ from the plain run's")
        require(param_err <= 1e-6, "(a): the params differ from the plain "
                "run's")
        evals = [[(it, v) for kind, it, v in run[2] if kind == "eval"]
                 for run in (runs["kernel"], plain)]
        require([it for it, _ in evals[0]] == [it for it, _ in evals[1]]
                == list(range(WIDE_PRETRAIN, last + 1, k)),
                "(a) evaluations at {}".format(evals))
        eval_err = max(abs(a[name] - b[name]) for (_, a), (_, b) in
                       zip(*evals) for name in ("accuracy", "exact_match"))
        print("(a) evaluations' accuracy and exact match, kernels vs plain: "
              "max |err| {:.3e} (atol 1e-6)".format(eval_err))
        require(eval_err <= 1e-6, "(a): the evaluations differ from the "
                "plain run's")
        best = root / "a_kernel" / "model_best.msgpack"
        require(best.exists(), "(a): no model_best was written (dev exact "
                "match {})".format([v["exact_match"] for _, v in evals[0]]))
        with open(str(best) + ".json") as f:
            best_meta = json.load(f)
        chunk_ms = [1e3 / v["steps_per_s"] for kind, it, v in events
                    if kind == "train" and it > WIDE_PRETRAIN]
        times["a: graphed chunk, ms a step (host clock)"] = chunk_ms
        print("(a) model_best {}; graphed chunk {} ms a step (host clock, "
              "the loop's windows); train() {:.2f} s, plain {:.2f} s; "
              "{}".format(best_meta, ["{:.3f}".format(x) for x in chunk_ms],
                          wall, plain[4], smi))
        # Four streamed steps, against the plain versions.
        streamed = {}
        for name, impl in (("kernel", "fused"), ("plain", "plain")):
            events = []
            zero_counts()
            state, _ = loop.train(
                str(FIXTURE / "dataset.txt"), str(FIXTURE),
                **train_kw(resume_from_file=pre_path,
                           max_training_iterations=WIDE_PRETRAIN + 3,
                           print_every=1, evaluate_every=4 * WIDE_PRETRAIN,
                           steps_per_execution=1, teacher_forced_impl=impl,
                           output_directory=str(root / ("s_" + name)),
                           callback=lambda *event: events.append(event)))
            sync()
            streamed[name] = (state, [v["loss"] for _, _, v in events],
                              counts(), [1e3 / v["steps_per_s"]
                                         for _, _, v in events[1:]])
        rel = max(abs(a - b) / abs(b) for a, b in zip(streamed["kernel"][1],
                                                      streamed["plain"][1]))
        param_err = max(float((a - b).abs().max()) for a, b in zip(
            leaves(streamed["kernel"][0].params),
            leaves(streamed["plain"][0].params)))
        times["a: streamed, ms a step (host clock)"] = streamed["kernel"][3]
        print("(a) streamed: launches {}; per-step losses {} vs plain {} "
              "(max rel err {:.3e}, rtol 1e-5); params max |err| {:.3e} "
              "(atol 1e-6); {} ms a step (host clock), plain {}".format(
                  streamed["kernel"][2],
                  ["{:.6f}".format(x) for x in streamed["kernel"][1]],
                  ["{:.6f}".format(x) for x in streamed["plain"][1]], rel,
                  param_err,
                  ["{:.3f}".format(x) for x in streamed["kernel"][3]],
                  ["{:.3f}".format(x) for x in streamed["plain"][3]]))
        require(all(streamed["kernel"][2][name] == 4 for name in tf.launches)
                and len(streamed["kernel"][1]) == 4 and rel <= 1e-5
                and param_err <= 1e-6,
                "(a): the streamed steps differ from the plain run's")
        data = resident.build_resident_data(train_set, DEVICE)
        step_batch = resident.gather_batch(data, next(
            resident.index_block_stream(data.num_examples, TRAIN_BATCH, 1,
                                        np.random.default_rng(SEED)))[0])
        require_kernels("(a) one train step", lambda: train_step(
            pre_state, step_batch, config, Adam()),
            ("forward_grid_kernel", "backward_grid_kernel",
             "weight_grads_wide_kernel"), sync)
        del data, step_batch, runs, streamed, state

        # (b) The block decode, predict_and_save and evaluate of model_best.
        params = load_params(str(best), device=DEVICE)
        decode = greedy.make_greedy_decoder(config, MAX_DECODING_STEPS,
                                            EXIT_CHECK_EVERY,
                                            decode_impl="block")
        decode_plain = greedy.make_greedy_decoder(
            config, MAX_DECODING_STEPS, EXIT_CHECK_EVERY,
            decode_impl="block_plain")
        with torch.no_grad():
            out = decode(params, *inputs)
            plain_out = decode_plain(params, *inputs)
        found = decode_divergences(out, plain_out, WIDE_EXAMPLES)
        check_divergences("(b) block decode vs plain", found)
        same = torch.ones(WIDE_EXAMPLES, dtype=torch.bool, device=DEVICE)
        same[[row for row, _, _ in found]] = False
        for name in ("attention_commands", "attention_situations"):
            check_close("(b) block decode vs plain, {} of the rows that "
                        "agree".format(name), getattr(out, name)[same],
                        getattr(plain_out, name)[same], 1e-5, 1e-6)
        em = exact_match(out, dataset, indices, eos)
        print("(b) block decode: exact match {:.4f}%, emitted tokens "
              "{}".format(em, int(out.lengths.sum())))
        require_kernels("(b) one decode", lambda: decode(params, *inputs),
                        ("decode_grid_kernel",), sync)
        with torch.no_grad(), full_float32():
            blocks = fixture_blocks(params, config, batch)
            row_steps = [int(k2.decode_block_plain(
                *args, num_steps=EXIT_CHECK_EVERY,
                eos_idx=eos).step_emitted.sum()) for args in blocks]
        weights_bytes = sum(w.numel() * 4 for w in blocks[0][7])
        for i, args in enumerate(blocks):
            block_ms = cuda_ms(lambda: k2.fused_decode_block(
                *args, num_steps=EXIT_CHECK_EVERY, eos_idx=eos), 5)
            bound = bound_ms(*decode_block_work(
                WIDE_EXAMPLES, m_t, m_v, h, config.target_vocabulary_size,
                EXIT_CHECK_EVERY, weights_bytes, row_steps[i]))
            times["b: kernel 2 block {} ms".format(i + 1)] = block_ms
            print("(b) kernel 2, block {} of the decode (K={}, B={}, {} "
                  "emitting row-steps): {:.4f} ms, bound {:.4f} ms ({}); "
                  "{}".format(i + 1, EXIT_CHECK_EVERY, WIDE_EXAMPLES,
                              row_steps[i], block_ms, *bound, smi))
        del blocks
        times["b: block decode ms (wall)"] = predict_checks(
            "(b)", dataset, params, config, out, em, inputs, decode, sync,
            WIDE_EXAMPLES)

        # (c) The bf16 decodes and the float32 step decode (kernel 1).
        _, bf16_times = bf16_decodes(params, config, inputs, dataset, indices,
                                     out, plain_out, em, sync, flips=None,
                                     label="(c) ")
        zero_counts()
        step = greedy.make_greedy_decoder(config, MAX_DECODING_STEPS,
                                          EXIT_CHECK_EVERY, decode_impl="step")
        begin = time.perf_counter()
        with torch.no_grad():
            step_out = step(params, *inputs)
        sync()
        step_ms = (time.perf_counter() - begin) * 1e3
        print("(c) float32 step decode: kernel 1 launches {}, kernel 2 {}; "
              "{:.3f} ms (one run, wall clock); {}".format(
                  k1.launches, k2.launches, step_ms, smi))
        require(k1.launches > 0 and k2.launches == 0,
                "(c): the step decode did not run kernel 1 alone")
        check_divergences("(c) step decode vs plain",
                          decode_divergences(step_out, plain_out,
                                             WIDE_EXAMPLES))
        times.update({"c: {} decode ms (wall)".format(d): t
                      for d, t in bf16_times.items()})
        times["c: float32 step decode ms (wall)"] = step_ms
        del step_out

        # (d) The campaign, each seed against its single-seed run (C.14).
        _, bits = campaign_against_singles(
            "(d) H = {} campaign".format(h), root / "d", WIDE_SEEDS, 2 * k,
            k, sync, max_testing_examples=WIDE_EXAMPLES,
            evaluation_batch_size=WIDE_EXAMPLES, **width)
        require(bits, "(d): a campaign seed is not bit for bit its "
                "single-seed run")

        # (e) Data parallel at one rank (C.14).
        times["e: unsharded decode ms (wall)"] = data_parallel_one_rank(
            train_set, config, pre_state, k, params, config, inputs, out,
            sync, label="(e) H = {} one-rank NCCL mesh".format(h))

        # (f) The command line.
        times["f: --mode=train s"], times["f: --mode=test s"] = cli_checks(
            "(f) cli", dataset, config, sync, pre_path, WIDE_PRETRAIN,
            WIDE_PRETRAIN + k, k, k, WIDE_EXAMPLES, WIDE_EXAMPLES,
            flags=["--encoder_hidden_size={}".format(h),
                   "--decoder_hidden_size={}".format(h)], test_best=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("wide decoder at H = {}, times: {}; {}".format(
        h, json.dumps(times), smi))


def as_bf16(args, small):
    """Kernel 1's arguments with the keys in bf16 and the queries, mask and
    energy vector in ``small``."""
    import torch
    pq, keys, mask, energy = args
    return (pq.to(small), keys.to(torch.bfloat16),
            None if mask is None else mask.to(small), energy.to(small))


def bf16_decodes(params, config, inputs, dataset, indices, f32_out,
                 plain_out, em_f32, sync, flips=JAX_BF16_FLIPS, label=""):
    """The rows ``indices`` of ``dataset`` (``inputs``) through each bf16
    decode variant (the step path, whose attentions are kernel 1's bf16
    form): exact match and the rows whose tokens differ from the float32
    decode ``f32_out``, each with the float32 plain decode's (``plain_out``)
    top-2 logit gap at the first differing step. With ``flips``, each
    variant may change only rows that the JAX package's decode of the same
    variant changes on the CPU. Without, each variant is held to the same
    decode with kernel 1 swapped for its plain version on the same bf16
    inputs: its tokens may differ only at that decode's argmax near-ties
    (``bf16_near_ties``). Each variant must launch kernel 1's bf16 form, and
    neither its float32 form nor kernel 2 (the plain run none); the counts
    are set to 0 before each variant and read after it. Returns the bf16
    form's launches over the three decodes and each variant's wall-clock
    ms."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.decode import greedy
    from multimodal_seq2seq_gscan_tpu_torch.ops import additive_attention as k1
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    rows_in = len(indices)
    launches, times = 0, {}
    for dtype in ("bfloat16", "bfloat16_mixed", "bfloat16_keys"):
        k1.launches, k1.launches_bf16, k2.launches = 0, 0, 0
        decode = greedy.make_greedy_decoder(
            config, MAX_DECODING_STEPS, EXIT_CHECK_EVERY, decode_impl="step",
            compute_dtype=dtype)
        start = time.perf_counter()
        out = decode(params, *inputs)
        sync()
        times[dtype] = ms = (time.perf_counter() - start) * 1e3
        counts = (k1.launches_bf16, k1.launches, k2.launches)
        require(tuple(out.tokens.shape) == (rows_in, MAX_DECODING_STEPS + 1)
                and out.attention_situations.dtype == torch.float32
                and bool(torch.isfinite(out.attention_commands).all())
                and bool(torch.isfinite(out.attention_situations).all()),
                "{}{} decode: outputs of the wrong shape, dtype or not "
                "finite".format(label, dtype))
        emitted, ref_emitted = out.emitted_mask > 0, f32_out.emitted_mask > 0
        differ = (((out.tokens * emitted) != (f32_out.tokens * ref_emitted))
                  | (emitted != ref_emitted)).any(dim=1)
        rows = differ.nonzero().flatten().tolist()
        gaps = divergences(out.tokens, out.emitted_mask, plain_out.tokens,
                           plain_out.emitted_mask, plain_out.top2_gap)
        em = exact_match(out, dataset, indices, config.target_eos_idx)
        print("{}{} decode ({:.3f} ms, one run, wall clock): exact match "
              "{:.4f}% (float32 {:.4f}%); {} of {} rows differ from the "
              "float32 decode; against the float32 plain decode (row, first "
              "differing step, its top-2 logit gap): {}".format(
                  label, dtype, ms, em, em_f32, len(rows), rows_in,
                  gaps[:40]))
        if flips is None:
            bf16_near_ties(label + dtype, decode, params, inputs, out,
                           bf16_state=dtype != "bfloat16_keys")
        else:
            require(set(rows) <= set(flips[dtype]),
                    "{} decode: rows {} differ from float32; the JAX "
                    "package's decode changes only {}".format(
                        dtype, rows, flips[dtype]))
        print("launches, {}{} decode: kernel 1's bf16 form {}, its float32 "
              "form {}, kernel 2 {}".format(label, dtype, *counts))
        require(counts[0] > 0 and counts[1] == 0 and counts[2] == 0,
                "the {}{} decode did not run kernel 1's bf16 form "
                "alone".format(label, dtype))
        launches += counts[0]
    return launches, times


def bf16_near_ties(label, decode, params, inputs, out, bf16_state):
    """Holds a bf16 step decode's output ``out`` to ``decode`` run again
    with kernel 1 swapped for its plain version (same bf16 inputs, which it
    widens to float32 as the kernel does), recording that run's top-2
    logit gap at every step: a row may differ only where that gap, at the
    first differing step, is below NEAR_TIE, or (``bf16_state``: the loop's
    h and c in bf16) below two bf16 spacings of the top logit, the most
    that rounding one bf16 logit can move two apart. Prints every
    differing row."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.decode import greedy
    from multimodal_seq2seq_gscan_tpu_torch.ops import additive_attention as k1
    step_gaps, step_bars = [], []

    def recording_step(*args, **kwargs):
        result = greedy_step(*args, **kwargs)
        top = result[0].float().topk(2, dim=-1).values
        step_gaps.append(top[:, 0] - top[:, 1])
        spacing = torch.exp2(torch.floor(torch.log2(top[:, 0].abs())) - 7)
        step_bars.append(torch.clamp(2 * spacing, min=NEAR_TIE) if bf16_state
                         else torch.full_like(spacing, NEAR_TIE))
        return result

    greedy_step = greedy.decoder_step
    k1.launches, k1.launches_bf16 = 0, 0
    with patched(k1, "additive_attention", k1.additive_attention_plain), \
            patched(greedy, "decoder_step", recording_step):
        ref = decode(params, *inputs)
    require(k1.launches == k1.launches_bf16 == 0, "{}: the plain "
            "attention's decode launched kernel 1".format(label))
    pad = ref.tokens.shape[1] - len(step_gaps)
    gap, bar = (torch.nn.functional.pad(torch.stack(x, dim=1), (0, pad),
                                        value=float("inf"))
                for x in (step_gaps, step_bars))
    found = divergences(out.tokens, out.emitted_mask, ref.tokens,
                        ref.emitted_mask, gap)
    faults = [(row, step, g) for row, step, g in found
              if g >= float(bar[row, step])]
    print("{} decode vs the same decode on kernel 1's plain version: {} "
          "rows differ (row, first differing step, top-2 gap, tie bar): "
          "{}".format(label, len(found), [
              (row, step, g, float(bar[row, step]))
              for row, step, g in found]))
    require(not faults, "{}: tokens differ from the plain attention's "
            "decode away from a near-tie: {}".format(label, faults))


def cli_checks(label, dataset, config, sync, resume, start, last, k,
               evaluate_every, examples, test_batch, flags=(), words=None,
               min_exact=None, test_best=False):
    """The port's command line in process on the card
    (``cli.seq2seq.main``, ``flags`` beside the common ones):
    ``--mode=train`` resumed from ``resume`` (at iteration ``start``) to
    iteration ``last`` in graphed chunks of ``k`` steps (kernels 3, 4 and
    the helper) with a dev evaluation of ``examples`` examples every
    ``evaluate_every`` (kernel 2), the last above ``min_exact`` where
    given; then ``--mode=test`` on ``resume`` (with ``test_best``, on the
    run's model_best) writing ``dev_predict.json`` for the first
    ``examples`` dev examples at batch ``test_batch``: byte for byte the
    in-process ``predict_and_save`` of that checkpoint (model ``config``),
    and with ``words``, those predictions."""
    import logging
    from multimodal_seq2seq_gscan_tpu_torch.cli import seq2seq
    from multimodal_seq2seq_gscan_tpu_torch.decode.predict import (
        predict_and_save)
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    from multimodal_seq2seq_gscan_tpu_torch.train.checkpoint import (
        load_params)

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.lines = []

        def emit(self, record):
            message = record.getMessage()
            if "Evaluation Accuracy" in message or "Iteration" in message:
                self.lines.append(message)

    lines = Lines()
    loop_logger = logging.getLogger("multimodal_seq2seq_gscan_tpu_torch")
    level = loop_logger.level
    loop_logger.setLevel(logging.INFO)
    loop_logger.addHandler(lines)
    out_dir = tempfile.mkdtemp(prefix="gscan_chip_smoke_cli_")
    common = ["--data_directory=" + str(FIXTURE),
              "--output_directory=" + out_dir,
              "--max_decoding_steps={}".format(MAX_DECODING_STEPS),
              "--max_testing_examples={}".format(examples),
              "--seed={}".format(SEED)] + list(flags)
    try:
        k2.launches = 0
        tf.launches.update({name: 0 for name in tf.launches})
        begin = time.perf_counter()
        seq2seq.main(vars(seq2seq.build_parser().parse_args(
            ["--mode=train", "--resume_from_file=" + resume] + common + [
                "--training_batch_size={}".format(TRAIN_BATCH),
                "--test_batch_size={}".format(examples),
                "--max_training_iterations={}".format(last),
                "--print_every={}".format(k),
                "--evaluate_every={}".format(evaluate_every),
                "--steps_per_execution={}".format(k)])), device=DEVICE)
        sync()
        train_s = time.perf_counter() - begin
        launches = dict(tf.launches, decode_block=k2.launches)
        with open(os.path.join(out_dir, "checkpoint.msgpack.json")) as f:
            meta = json.load(f)
        tested = (os.path.join(out_dir, "model_best.msgpack") if test_best
                  else resume)
        require(os.path.exists(tested), "{} --mode=train wrote no "
                "model_best: {}".format(label, sorted(os.listdir(out_dir))))
        k2.launches = 0
        begin = time.perf_counter()
        seq2seq.main(vars(seq2seq.build_parser().parse_args(
            ["--mode=test", "--resume_from_file=" + tested] + common + [
                "--splits=dev", "--test_batch_size={}".format(test_batch)])),
            device=DEVICE)
        sync()
        test_s = time.perf_counter() - begin
        launches_test = k2.launches
        in_process = os.path.join(out_dir, "in_process_predict.json")
        predict_and_save(dataset, load_params(tested, device=DEVICE), config,
                         in_process, MAX_DECODING_STEPS,
                         batch_size=test_batch,
                         max_testing_examples=examples, device=DEVICE)
        with open(os.path.join(out_dir, "dev_predict.json"), "rb") as f:
            raw = f.read()
        with open(in_process, "rb") as f:
            equal = raw == f.read()
        written = json.loads(raw)
    finally:
        loop_logger.removeHandler(lines)
        loop_logger.setLevel(level)
        shutil.rmtree(out_dir, ignore_errors=True)
    for line in lines.lines:
        print("{}: {}".format(label, line))
    print("{} --mode=train: {:.2f} s, checkpoint meta {}; launches (kernels "
          "3, 4 and the helper: warm-up, capture and single steps) "
          "{}".format(label, train_s, meta, launches))
    evaluations = [line for line in lines.lines
                   if "Evaluation Accuracy" in line]
    require(all(count > 0 for count in launches.values()),
            "{}: a kernel of the training path was not launched".format(
                label))
    require(meta["iteration"] == last + 1 and len(evaluations) == len(
        range(start, last + 1, evaluate_every)),
        "{} --mode=train: meta {}, evaluations {}".format(label, meta,
                                                         evaluations))
    exact = float(evaluations[-1].split("Exact Match:")[1].split()[0])
    require(min_exact is None or exact > min_exact,
            "{} --mode=train: dev exact match {}".format(label, exact))
    same = len(written) if words is None else sum(
        record["prediction"] == w for record, w in zip(written, words))
    print("{} --mode=test: {:.2f} s, {} records, kernel 2 launches {}; "
          "dev_predict.json against the in-process predict_and_save: "
          "{}{}".format(label, test_s, len(written), launches_test,
                        "byte for byte" if equal else "DIFFER",
                        "" if words is None else "; {} of {} predictions "
                        "equal the decode's".format(same, examples)))
    require(launches_test > 0, "{} --mode=test did not launch kernel "
            "2".format(label))
    require(equal and len(written) == same == examples,
            "{} --mode=test: dev_predict.json differs".format(label))
    return train_s, test_s


def two_layer_checks(train_set, config, sync):
    """A decoder of two layers (and inter-layer dropout) on random weights
    from SEED: a graphed resident chunk of TWO_LAYER_K steps of the step
    unroll (kernel 1 with its plain backward) against as many eager steps,
    dropout on, held as ``hold_chunk``; kernel 1 must be launched in it."""
    import numpy as np
    from multimodal_seq2seq_gscan_tpu_torch.ops import additive_attention as k1
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    from multimodal_seq2seq_gscan_tpu_torch.train import resident
    from multimodal_seq2seq_gscan_tpu_torch.train.state import (
        Adam, create_train_state)
    from multimodal_seq2seq_gscan_tpu_torch.train.step import train_step
    config = config._replace(num_decoder_layers=2)
    optimizer = Adam()
    state = create_train_state(SEED, config, optimizer, device=DEVICE)
    data = resident.build_resident_data(train_set, DEVICE)
    block = next(resident.index_block_stream(
        data.num_examples, TRAIN_BATCH, TWO_LAYER_K,
        np.random.default_rng(SEED)))
    k1.launches = 0
    tf.launches.update({name: 0 for name in tf.launches})
    start = time.perf_counter()
    graphed = resident.make_train_chunk(config, optimizer)(state, data,
                                                           block)
    sync()
    chunk_s = time.perf_counter() - start
    launches = k1.launches
    eager, metrics = state, []
    for row in block:
        eager, step_metrics = train_step(
            eager, resident.gather_batch(data, row), config, optimizer)
        metrics.append(step_metrics)
    print("two-layer decoder, resident chunk of {} steps (T={}): captured "
          "and run in {:.2f} s; kernel 1 launches {}, kernels 3 and 4 "
          "{}".format(TWO_LAYER_K, data.target_ids.shape[1], chunk_s,
                      launches, dict(tf.launches)))
    require(launches > 0 and all(n == 0 for n in tf.launches.values()),
            "the two-layer chunk did not run the step unroll's kernel 1")
    hold_chunk("two-layer decoder, graphed chunk vs eager steps", *graphed,
               eager, metrics)


def hold_states(label, got, want):
    """Two TrainStates' params and Adam moments: bit-identical, or within
    the resident bars (atol 1e-6). Returns whether bit-identical."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.models.params import leaves
    same, errors = True, {}
    for tree in ("params", "mu", "nu"):
        get = (lambda s: s.params) if tree == "params" else (
            lambda s, t=tree: getattr(s.opt_state, t))
        pairs = list(zip(leaves(get(got)), leaves(get(want))))
        same &= all(torch.equal(a, b) for a, b in pairs)
        errors[tree] = max(float((a - b).abs().max()) for a, b in pairs)
    print("{}: params, mu, nu {} (max |err| {:.3e}, {:.3e}, {:.3e}; "
          "atol 1e-6)".format(label, "bit-identical" if same else
                              "not bit-identical", errors["params"],
                              errors["mu"], errors["nu"]))
    require(got.step == want.step
            and got.opt_state[0::3] == want.opt_state[0::3],
            "{}: the counts differ".format(label))
    require(max(errors.values()) <= 1e-6, "{}: past atol 1e-6".format(label))
    return same


def hold_events(label, got, want):
    """Two runs' logged metrics (``train``'s callback events, the host
    clock's steps/s left out): equal, or within rtol 2e-5 / atol 1e-6.
    Returns whether equal."""
    def values(events):
        return [(kind, it, {k: v for k, v in vals.items()
                            if k not in ("seed", "steps_per_s")})
                for kind, it, vals in events]

    got, want = values(got), values(want)
    require([e[:2] for e in got] == [e[:2] for e in want],
            "{}: logged {} against {}".format(label, [e[:2] for e in got],
                                              [e[:2] for e in want]))
    same = got == want
    for (_, it, a), (_, _, b) in zip(got, want):
        for name in b:
            require(abs(a[name] - b[name]) <= 1e-6 + 2e-5 * abs(b[name]),
                    "{}: {} at {}: {} against {}".format(
                        label, name, it, a[name], b[name]))
    print("{}: {} logged windows and evaluations {}".format(
        label, len(got), "equal" if same else "within rtol 2e-5 / atol "
        "1e-6"))
    return same


def train_run(root, out, steps, sync, **options):
    """``train()`` on the fixture for ``steps`` steps into ``root/out`` in
    graphed chunks (``options`` complete or override the batch, periods,
    chunk size and evaluation of the multi-seed phase); returns (state,
    logged events, wall seconds)."""
    from multimodal_seq2seq_gscan_tpu_torch.train.loop import train
    events = []
    start = time.perf_counter()
    state, _ = train(str(FIXTURE / "dataset.txt"), str(FIXTURE),
                     output_directory=str(root / out),
                     max_training_iterations=steps,
                     callback=lambda *event: events.append(event),
                     **dict(dict(training_batch_size=TRAIN_BATCH,
                                 print_every=MULTISEED_K,
                                 evaluate_every=MULTISEED_K,
                                 steps_per_execution=MULTISEED_K,
                                 max_testing_examples=STEP_EXAMPLES,
                                 evaluation_batch_size=STEP_EXAMPLES,
                                 device=DEVICE), **options))
    sync()
    return state, events, time.perf_counter() - start


def campaign_against_singles(label, root, seeds, steps, k, sync,
                             **options):
    """``train(seeds=...)`` of ``seeds`` for ``steps`` steps in graphed
    chunks of ``k`` (one graph runs each seed's chunk in turn), a dev
    evaluation per seed through kernel 2 after each chunk, into
    ``root/campaign``, its launches counted (kernels 3, 4, the helper and
    2 required); then each seed held against a single-seed
    ``train(seed=s)`` of the same steps: params, moments, logged metrics
    and checkpoint files. Returns (the campaign's stacked state, whether
    every seed was bit for bit its single-seed run)."""
    import filecmp
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    from multimodal_seq2seq_gscan_tpu_torch.train import multiseed
    options = dict(options, print_every=k, evaluate_every=k,
                   steps_per_execution=k)
    listed = ",".join(str(s) for s in seeds)
    k2.launches = 0
    tf.launches.update({name: 0 for name in tf.launches})
    stacked, events, campaign_s = train_run(root, "campaign", steps, sync,
                                            seeds=listed, **options)
    launches = dict(tf.launches, decode_block=k2.launches)
    print("{} of seeds {} ({} steps, K={}): {:.2f} s; launches (kernels "
          "3, 4 and the helper: warm-up and capture; kernel 2: the dev "
          "evaluations) {}".format(label, listed, steps, k, campaign_s,
                                   launches))
    require(all(count > 0 for count in launches.values()),
            "a kernel of the {}'s path was not launched".format(label))
    for kind, it, values in events:
        print("{} {} {} [seed {}]: {}".format(
            label, kind, it, values["seed"], ", ".join(
                "{} {:.6g}".format(name, v) for name, v in values.items()
                if name != "seed")))
    evaluations = [(it, v["seed"]) for kind, it, v in events
                   if kind == "eval"]
    require(evaluations == [(it, s) for it in range(k, steps + 1, k)
                            for s in seeds],
            "{} evaluations: {}".format(label, evaluations))
    require(all(math.isfinite(v["loss"]) for kind, _, v in events
                if kind == "train"), "{} losses are not finite".format(
                    label))
    bars = []
    for i, s in enumerate(seeds):
        single, single_events, single_s = train_run(
            root, "single_{}".format(s), steps, sync, seed=s, **options)
        seed_label = "{}, seed {}: campaign vs train(seed={}) ({:.2f} " \
            "s)".format(label, s, s, single_s)
        same = hold_states(seed_label, multiseed.slice_train_state(
            stacked, i), single)
        same &= hold_events(seed_label, [e for e in events
                                         if e[2]["seed"] == s],
                            single_events)
        files = sorted(os.listdir(root / "single_{}".format(s)))
        require(files == sorted(os.listdir(
            root / "campaign" / "seed_{}".format(s))),
            "{}: the files differ".format(seed_label))
        equal_bytes = all(filecmp.cmp(
            root / "single_{}".format(s) / name,
            root / "campaign" / "seed_{}".format(s) / name,
            shallow=False) for name in files)
        require(equal_bytes or not same,
                "{}: bit-identical states, different files".format(
                    seed_label))
        print("{}: files {} {}".format(seed_label, files, "byte-equal"
                                       if equal_bytes else "differ"))
        bars.append(same)
    print("{}: bar held: {}".format(label, (
        "bit for bit (every seed)" if all(bars) else
        "the resident bars (metrics rtol 2e-5 / atol 1e-6, params and "
        "moments atol 1e-6)")))
    return stacked, all(bars)


def multiseed_checks(train_set, config, sync):
    """The multi-seed campaign on the card, fresh from each seed's init at
    the flagship width: (a) ``train(seeds=...)`` of MULTISEED_SEEDS for
    MULTISEED_STEPS steps in graphed chunks of MULTISEED_K, a dev
    evaluation of STEP_EXAMPLES examples per seed after each chunk, each
    seed held against a single-seed ``train(seed=s)`` of the same steps
    (``campaign_against_singles``); (b) a campaign run by the command
    line's ``--seeds`` to its first chunk and resumed by ``train``, held
    against the uninterrupted one; (c) ms per step per seed of the
    campaign's graph against one seed's graphed chunk and against the
    seeds' single-seed graphs replayed in turn, with the device busy share
    (torch.profiler)."""
    import numpy as np
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.cli import seq2seq
    from multimodal_seq2seq_gscan_tpu_torch.train import multiseed, resident
    from multimodal_seq2seq_gscan_tpu_torch.train.state import (
        Adam, create_train_state)
    seeds = ",".join(str(s) for s in MULTISEED_SEEDS)
    root = Path(tempfile.mkdtemp(prefix="gscan_chip_smoke_multiseed_"))
    try:
        # (a) The campaign against its seeds' single runs.
        stacked, _ = campaign_against_singles(
            "campaign", root, MULTISEED_SEEDS, MULTISEED_STEPS, MULTISEED_K,
            sync)
        # (b) Stopped after the first chunk (through the command line's
        # --seeds), resumed through train().
        seq2seq.main(vars(seq2seq.build_parser().parse_args([
            "--mode=train", "--data_directory=" + str(FIXTURE),
            "--output_directory=" + str(root / "resumed"),
            "--seeds=" + seeds,
            "--training_batch_size={}".format(TRAIN_BATCH),
            "--max_training_iterations={}".format(MULTISEED_K),
            "--print_every={}".format(MULTISEED_K),
            "--evaluate_every={}".format(MULTISEED_K),
            "--steps_per_execution={}".format(MULTISEED_K),
            "--max_testing_examples={}".format(STEP_EXAMPLES),
            "--test_batch_size={}".format(STEP_EXAMPLES),
            "--max_decoding_steps={}".format(MAX_DECODING_STEPS)])),
            device=DEVICE)
        resumed, _, resumed_s = train_run(
            root, "resumed", MULTISEED_STEPS, sync, seeds=seeds,
            resume_from_file=str(root / "resumed"))
        same = [hold_states(
            "seed {}: resumed campaign vs uninterrupted ({:.2f} s)".format(
                s, resumed_s), multiseed.slice_train_state(resumed, i),
            multiseed.slice_train_state(stacked, i))
            for i, s in enumerate(MULTISEED_SEEDS)]
        print("resumed campaign: bar held: {}".format(
            "bit for bit" if all(same) else "the resident bars (atol 1e-6)"))
        del stacked, resumed
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # (c) Times: the campaign's graph against the seeds' single graphs.
    optimizer = Adam()
    data = resident.build_resident_data(train_set, DEVICE)
    states = [create_train_state(s, config, optimizer, device=DEVICE)
              for s in MULTISEED_SEEDS]
    blocks = np.stack([next(resident.index_block_stream(
        data.num_examples, TRAIN_BATCH, MULTISEED_K,
        np.random.default_rng(s))) for s in MULTISEED_SEEDS])
    stacked = multiseed.stack_train_states(states)
    multi = multiseed.make_multiseed_train_chunk(config, optimizer)
    single = resident.make_train_chunk(config, optimizer)
    n, k = len(MULTISEED_SEEDS), MULTISEED_K
    runs = (("one graph of {} seeds x {} steps".format(n, k),
             lambda: multi(stacked, data, blocks), n * k),
            ("{} replays of the single-seed graph (the S-graph "
             "variant)".format(n),
             lambda: [single(state, data, block)
                      for state, block in zip(states, blocks)], n * k),
            ("one seed's graphed chunk", lambda: single(
                states[0], data, blocks[0]), k))
    times = {}
    for label, fn, steps in runs:
        ms = cuda_ms(fn, 3, warmup=1) / steps
        wall_ms, device_events, busy_ms = device_window(fn, sync)
        times[label] = ms
        print("{}: {:.3f} ms a step a seed; profiled: wall {:.3f} ms, "
              "device busy {} a step".format(
                  label, ms, wall_ms / steps,
                  "{:.3f} ms ({:.1f}%)".format(
                      busy_ms / steps, 100 * busy_ms / wall_ms)
                  if busy_ms > 0 else "not measured"))
    first, _ = multi(stacked, data, blocks)
    second, _ = multi(stacked, data, blocks)
    print("the campaign's graph replayed twice from one state: {}".format(
        "bit-identical" if torch.equal(first.flat, second.flat)
        else "max |err| {:.3e}".format(float(
            (first.flat - second.flat).abs().max()))))
    del first, second
    one, s_graphs = times[runs[0][0]], times[runs[1][0]]
    print("campaign graph against the S-graph variant: {:.3f} against "
          "{:.3f} ms a step a seed ({:+.1f}%); kept: the one graph{}".format(
              one, s_graphs, 100 * (one / s_graphs - 1),
              "" if one <= s_graphs else " (slower here: see PERF.md)"))


def require_same_split(split, got, want):
    """A split loaded by the native scanner (``got``) and by json
    (``want``): the same arrays, ids, strings and vocabularies."""
    import numpy as np
    require(got.backend == "native" and want.backend == "engine",
            "backends {} and {}".format(got.backend, want.backend))
    for name in ("_situations", "_input_lengths", "_target_lengths",
                 "_agent_positions", "_target_positions"):
        a, b = getattr(got, name), getattr(want, name)
        require(a.dtype == b.dtype and np.array_equal(a, b),
                "native {} {} differs".format(split, name))
    require(got.num_examples == want.num_examples and all(
        np.array_equal(a, b) for a, b in zip(got.input_ids, want.input_ids))
        and all(np.array_equal(a, b) for a, b in zip(
            got.target_ids, want.target_ids)),
        "native {} ids differ".format(split))
    require(all(got._situation_representations[i]
                == want._situation_representations[i]
                and got._derivation_representations[i]
                == want._derivation_representations[i]
                for i in range(got.num_examples)),
            "native {} strings differ".format(split))
    require(got.input_vocabulary.to_dict() == want.input_vocabulary.to_dict()
            and got.target_vocabulary.to_dict()
            == want.target_vocabulary.to_dict(),
            "native {} vocabularies differ".format(split))


def native_loader_checks(dataset, params, config, sync):
    """The port's C++ scanner on the card's host: built from the
    checkout's source, the fixture loaded by ``"native"`` and ``"engine"``
    (train and dev sharing one parse) with equal arrays, vocabularies and
    strings, both load times; ``"auto"`` must take native; and
    ``--mode=test`` of STEP_EXAMPLES records through the native backend
    must write the engine backend's ``dev_predict.json`` byte for byte."""
    from multimodal_seq2seq_gscan_tpu_torch.cli import seq2seq
    from multimodal_seq2seq_gscan_tpu_torch.data import native_loader
    from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
        GroundedScanDataset)
    from multimodal_seq2seq_gscan_tpu_torch.decode.predict import (
        predict_and_save)
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    start = time.perf_counter()
    library = native_loader.build()
    print("native loader: {} ({:.2f} s to build or find)".format(
        library.name, time.perf_counter() - start))
    path = str(FIXTURE / "dataset.txt")
    loaded, seconds = {}, {}
    for backend in ("native", "engine"):
        start = time.perf_counter()
        dev = GroundedScanDataset(path, str(FIXTURE), split="dev",
                                  backend=backend)
        dev.read_dataset()
        train_split = GroundedScanDataset(path, str(FIXTURE), split="train",
                                          dataset=dev.dataset)
        train_split.read_dataset()
        seconds[backend] = time.perf_counter() - start
        loaded[backend] = (dev, train_split)
    for split, got, want in zip(("dev", "train"), loaded["native"],
                                loaded["engine"]):
        require_same_split(split, got, want)
    print("fixture (dev {} + train {} examples) loaded: native {:.3f} s, "
          "engine {:.3f} s; arrays, ids, strings and vocabularies "
          "equal".format(loaded["native"][0].num_examples,
                         loaded["native"][1].num_examples,
                         seconds["native"], seconds["engine"]))
    auto = GroundedScanDataset(path, str(FIXTURE), split="dev")
    require(auto.backend == "native", "'auto' took {}".format(auto.backend))
    out_dir = tempfile.mkdtemp(prefix="gscan_chip_smoke_native_")
    try:
        k2.launches = 0
        seq2seq.main(vars(seq2seq.build_parser().parse_args([
            "--mode=test", "--data_directory=" + str(FIXTURE),
            "--output_directory=" + out_dir,
            "--resume_from_file=" + str(FIXTURE / "model_best.msgpack"),
            "--max_decoding_steps={}".format(MAX_DECODING_STEPS),
            "--max_testing_examples={}".format(STEP_EXAMPLES),
            "--splits=dev", "--test_batch_size={}".format(BATCH)])),
            device=DEVICE)
        sync()
        launches = k2.launches
        engine_path = predict_and_save(
            loaded["engine"][0], params, config,
            os.path.join(out_dir, "engine_predict.json"),
            max_decoding_steps=MAX_DECODING_STEPS, batch_size=BATCH,
            max_testing_examples=STEP_EXAMPLES, device=DEVICE)
        with open(os.path.join(out_dir, "dev_predict.json"), "rb") as f:
            native_bytes = f.read()
        with open(engine_path, "rb") as f:
            engine_bytes = f.read()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print("--mode=test through the native backend: {} bytes, kernel 2 "
          "launches {}; the engine backend's predict.json {} bytes, "
          "{}".format(len(native_bytes), launches, len(engine_bytes),
                      "byte-equal" if native_bytes == engine_bytes
                      else "different"))
    require(launches > 0, "--mode=test did not launch kernel 2")
    require(native_bytes == engine_bytes,
            "dev_predict.json differs between the backends")


def read_png(path):
    """A PNG of the port's writer (8-bit RGB, row filter 0) back to its
    array, by zlib alone."""
    import struct
    import zlib
    import numpy as np
    with open(path, "rb") as f:
        data = f.read()
    require(data[:8] == b"\x89PNG\r\n\x1a\n", path + ": not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        length, = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    width, height = header[:2]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        height, 1 + 3 * width)
    require(header[2:] == (8, 2, 0, 0, 0) and not rows[:, 0].any(),
            path + ": not 8-bit RGB with filter 0")
    return rows[:, 1:].reshape(height, width, 3)


def gif_images(path):
    """The number of image descriptors of a GIF, by walking its blocks."""
    with open(path, "rb") as f:
        data = f.read()
    require(data[:6] == b"GIF89a", path + ": not GIF89a")
    pos = 13 + ((3 << ((data[10] & 7) + 1)) if data[10] & 0x80 else 0)
    images = 0
    while data[pos] != 0x3B:
        if data[pos] == 0x21:
            pos += 2
        elif data[pos] == 0x2C:
            images += 1
            flags = data[pos + 9]
            pos += 10 + ((3 << ((flags & 7) + 1)) if flags & 0x80 else 0) + 1
        else:
            raise SmokeFailure("{}: unknown GIF block {:#x}".format(
                path, data[pos]))
        while data[pos]:
            pos += data[pos] + 1
        pos += 1
    return images


def check_visualizations(root, folders, replay):
    """Each folder holds initial.png, situation_<i>.png for each step and a
    movie.gif of as many images; ``replay(folder, frames)`` holds the
    decoded PNGs to what they show. Returns the number of PNGs."""
    count = 0
    for folder in folders:
        names = os.listdir(folder)
        steps = sum(1 for n in names if n.startswith("situation_"))
        require(sorted(names) == sorted(
            ["initial.png", "movie.gif"]
            + ["situation_{}.png".format(i) for i in range(steps)]),
            "{}: files {}".format(folder, sorted(names)))
        frames = [read_png(os.path.join(folder, "initial.png"))] + [
            read_png(os.path.join(folder, "situation_{}.png".format(i)))
            for i in range(steps)]
        images = gif_images(os.path.join(folder, "movie.gif"))
        require(images == len(frames), "{}: {} GIF images for {} PNGs".format(
            os.path.relpath(folder, root), images, len(frames)))
        replay(folder, frames)
        count += len(frames)
    return count


def engine_checks(sync):
    """The dataset engine and its analysis tools (``gscan/``,
    ``analysis/``, ``cli/gscan.py``) on the card's host, feeding the card:
    (1) the oracle re-derives the target commands of all the fixture's
    examples; (2) ``--mode=generate`` of ENGINE_EXAMPLES generalization
    examples (k-shot 5, a dev set, renders of one example a split), its
    statistics, SVG plots, PNGs and GIFs checked; (3) ``--mode=augment_geca``
    of up to ENGINE_GECA examples, reloaded by the native scanner and by
    json alike; (4) ``cli/seq2seq.py --mode=train`` from a fresh init at
    the fixture's widths, vocabularies from the generated train split,
    TRAIN_STEPS steps at batch TRAIN_BATCH in graphed chunks of RESIDENT_K
    (kernels 3, 4 and the helper; the last chunk's mean loss below the
    first's), then ``--mode=test`` of the generated test split (kernel 2);
    (5) ``--mode=error_analysis``, ``position_analysis`` and
    ``execute_commands --only_save_errors`` (ENGINE_VISUALIZED examples) on
    its predict.json. Outputs stay in chiprun_out/engine_smoke/, the
    datasets, predictions and checkpoint removed at the end."""
    import xml.etree.ElementTree as ElementTree
    import numpy as np
    from multimodal_seq2seq_gscan_tpu_torch.analysis.render import (
        render_situation)
    from multimodal_seq2seq_gscan_tpu_torch.cli import gscan as gscan_cli
    from multimodal_seq2seq_gscan_tpu_torch.cli import seq2seq
    from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
        GroundedScanDataset)
    from multimodal_seq2seq_gscan_tpu_torch.gscan import (
        GroundedScan, Situation)
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    from multimodal_seq2seq_gscan_tpu_torch.train import loop

    def gscan(*args):
        gscan_cli.main(vars(gscan_cli.build_parser().parse_args(list(args))))

    root = ROOT / "chiprun_out" / "engine_smoke"
    shutil.rmtree(root, ignore_errors=True)
    generated, geca, trained = (str(root / name) for name in
                                ("generated", "geca", "trained"))
    times = {}

    # (1) The oracle on the fixture.
    start = time.perf_counter()
    fixture = GroundedScan.load_dataset_from_file(
        str(FIXTURE / "dataset.txt"), str(root))
    replayed = 0
    for split in ("train", "dev"):
        for example in fixture._data_pairs[split]:
            commands, _, _ = fixture.demonstrate_command(
                fixture.parse_derivation_repr(example["derivation"]),
                Situation.from_representation(example["situation"]))
            require(",".join(commands) == example["target_commands"],
                    "oracle: {} example differs".format(split))
            replayed += 1
    times["oracle"] = time.perf_counter() - start
    print("oracle: {} fixture examples (train {}, dev {}) re-derived to "
          "their stored commands in {:.2f} s".format(
              replayed, len(fixture._data_pairs["train"]),
              len(fixture._data_pairs["dev"]), times["oracle"]))
    require(replayed == 4608, "the fixture has {} examples".format(replayed))

    # (2) Generation.
    start = time.perf_counter()
    gscan("--mode=generate", "--split=generalization", "--grid_size=6",
          "--type_grammar=adverb", "--max_examples={}".format(ENGINE_EXAMPLES),
          "--num_resampling=1", "--make_dev_set", "--k_shot_generalization=5",
          "--seed=1", "--visualize_per_split=1",
          "--output_directory=" + generated)
    times["generate"] = time.perf_counter() - start
    dataset_path = os.path.join(generated, "dataset.txt")
    scan = GroundedScan.load_dataset_from_file(dataset_path, generated)
    sizes = {split: len(examples)
             for split, examples in scan._data_pairs.items() if examples}
    print("--mode=generate: {:.2f} s; splits {}".format(times["generate"],
                                                        sizes))
    names = os.listdir(generated)
    for split in ("train", "dev", "test", "visual", "situational_1",
                  "situational_2", "contextual", "adverb_1", "adverb_2",
                  "visual_easier"):
        require(split + "_dataset_stats.txt" in names,
                "no statistics of " + split)
        if split in sizes:
            require(os.path.getsize(os.path.join(
                generated, split + "_dataset_stats.txt")) > 0,
                "empty statistics of " + split)
    svgs = [n for n in names if n.endswith(".svg")]
    for name in svgs:
        ElementTree.parse(os.path.join(generated, name))
    require(len(svgs) >= 10 * len(sizes) - 10,
            "{} SVG plots for {} splits".format(len(svgs), len(sizes)))
    require(not [n for n in names if n.endswith(".png")],
            "a plot was written as PNG")

    def replay_example(folder, frames):
        """The folder's initial frame is one example's situation, and its
        steps the oracle's demonstration of it."""
        command = os.path.basename(os.path.dirname(folder)).split("_")
        for split_examples in scan._data_pairs.values():
            for example in split_examples:
                if example["command"].split(",") != command:
                    continue
                situation = Situation.from_representation(
                    example["situation"])
                if not np.array_equal(render_situation(situation),
                                      frames[0]):
                    continue
                _, demonstration, _ = scan.demonstrate_command(
                    scan.parse_derivation_repr(example["derivation"]),
                    situation)
                require(len(demonstration) + 1 == len(frames) and all(
                    np.array_equal(render_situation(s), frame)
                    for s, frame in zip(demonstration, frames[1:])),
                    folder + ": frames differ from the demonstration")
                return
        raise SmokeFailure(folder + ": no example renders as initial.png")

    folders = sorted(str(p.parent) for p in Path(generated).glob(
        "*/situation_*/movie.gif"))
    require(folders, "--mode=generate rendered no example")
    pngs = check_visualizations(generated, folders, replay_example)
    print("renders: {} examples, {} PNGs decoded (zlib) equal to their "
          "situations rendered again; {} GIFs, one image a PNG; {} SVG "
          "plots parsed as XML".format(len(folders), pngs, len(folders),
                                       len(svgs)))

    # (3) GECA.
    start = time.perf_counter()
    gscan("--mode=augment_geca", "--load_dataset_from=" + dataset_path,
          "--max_augmented={}".format(ENGINE_GECA), "--seed=1",
          "--output_directory=" + geca)
    times["geca"] = time.perf_counter() - start
    geca_path = os.path.join(geca, "dataset.txt")
    loads = {}
    for backend in ("native", "engine"):
        split = GroundedScanDataset(geca_path, geca, split="train",
                                    generate_vocabulary=True,
                                    backend=backend)
        split.read_dataset()
        loads[backend] = split
    require_same_split("train", loads["native"], loads["engine"])
    added = loads["engine"].num_examples - sizes["train"]
    print("--mode=augment_geca: {:.2f} s, {} examples added to train ({} "
          "now); native and json loads equal".format(
              times["geca"], added, loads["engine"].num_examples))
    require(0 < added <= ENGINE_GECA, "GECA added {}".format(added))

    # (4) Into the card.
    chunk_losses = []
    make_chunk = loop.make_train_chunk

    def recording_chunk(*args, **kwargs):
        chunk = make_chunk(*args, **kwargs)

        def run(*chunk_args, **chunk_kwargs):
            state, metrics = chunk(*chunk_args, **chunk_kwargs)
            chunk_losses.append(metrics["loss"])
            return state, metrics
        return run

    common = ["--data_directory=" + generated,
              "--output_directory=" + trained, "--seed={}".format(SEED)]
    k2.launches = 0
    tf.launches.update({name: 0 for name in tf.launches})
    loop.make_train_chunk = recording_chunk
    try:
        start = time.perf_counter()
        seq2seq.main(vars(seq2seq.build_parser().parse_args(
            ["--mode=train", "--generate_vocabularies",
             "--training_batch_size={}".format(TRAIN_BATCH),
             "--max_training_iterations={}".format(TRAIN_STEPS),
             "--print_every={}".format(RESIDENT_K),
             "--evaluate_every={}".format(TRAIN_STEPS),
             "--steps_per_execution={}".format(RESIDENT_K)] + common)),
            device=DEVICE)
        sync()
        times["train"] = time.perf_counter() - start
    finally:
        loop.make_train_chunk = make_chunk
    train_launches = dict(tf.launches)
    means = [float(losses.double().mean()) for losses in chunk_losses]
    print("--mode=train: {:.2f} s, {} chunks of {} steps at batch {}, mean "
          "losses {}; launches {}".format(
              times["train"], len(means), RESIDENT_K, TRAIN_BATCH,
              ["{:.4f}".format(m) for m in means], train_launches))
    require(len(means) == TRAIN_STEPS // RESIDENT_K
            and all(math.isfinite(m) for m in means) and means[-1] < means[0],
            "training loss not finite and falling: {}".format(means))
    require(all(count > 0 for count in train_launches.values()),
            "a kernel of training was not launched: {}".format(
                train_launches))
    k2.launches = 0
    start = time.perf_counter()
    seq2seq.main(vars(seq2seq.build_parser().parse_args(
        ["--mode=test", "--splits=test",
         "--resume_from_file=" + os.path.join(trained, "checkpoint.msgpack"),
         "--test_batch_size={}".format(TRAIN_BATCH)] + common)),
        device=DEVICE)
    sync()
    times["test"] = time.perf_counter() - start
    with open(os.path.join(trained, "test_predict.json")) as f:
        records = json.load(f)
    exact = sum(record["exact_match"] for record in records)
    print("--mode=test: {:.2f} s, {} records ({} exact), kernel 2 launches "
          "{}".format(times["test"], len(records), exact, k2.launches))
    require(k2.launches > 0, "--mode=test did not launch kernel 2")
    require(len(records) == sizes["test"], "{} records for {} test "
            "examples".format(len(records), sizes["test"]))

    # (5) Analysis.
    start = time.perf_counter()
    analysed = ["--load_dataset_from=" + dataset_path,
                "--output_directory=" + trained,
                "--predicted_commands_files=test_predict.json"]
    gscan("--mode=error_analysis", *analysed)
    gscan("--mode=position_analysis", *analysed)
    gscan("--mode=execute_commands", "--only_save_errors",
          "--max_visualized={}".format(ENGINE_VISUALIZED), *analysed)
    times["analysis"] = time.perf_counter() - start
    report = os.path.join(trained, "test_predict", "error_analysis.txt")
    require(os.path.getsize(report) > 0, "empty error analysis")
    for xls in (os.path.join(trained, "test_predict", "error_analysis.xls"),
                os.path.join(trained, "position_analysis.xls")):
        with open(xls, "rb") as f:
            require(f.read(4) == b"\xd0\xcf\x11\xe0", xls + ": not OLE2")
    folders = sorted(str(p.parent) for p in Path(trained).glob(
        "errors/*/situation_*/movie.gif"))
    require(len(folders) == min(ENGINE_VISUALIZED, len(records) - exact),
            "{} visualized errors".format(len(folders)))
    require(not (Path(trained) / "exact_matches").exists(),
            "--only_save_errors saved an exact match")

    def same_shape(folder, frames):
        require(all(frame.shape == (6 * 60, 6 * 60, 3) for frame in frames),
                folder + ": frames of another shape")

    pngs = check_visualizations(trained, folders, same_shape)
    print("analysis: {:.2f} s; error_analysis.txt, its .xls, "
          "position_analysis.xls; {} visualized errors, {} PNGs and their "
          "GIFs".format(times["analysis"], len(folders), pngs))
    for path in (dataset_path, geca_path,
                 os.path.join(trained, "test_predict.json"),
                 os.path.join(trained, "checkpoint.msgpack")):
        os.remove(path)
    print("engine phase steps (s): {}".format(
        {name: round(value, 3) for name, value in times.items()}))


def data_parallel_one_rank(train_set, train_config, start, k, params, config,
                           inputs, decoded, sync, label="one-rank NCCL mesh"):
    """Phase (a) of "main path: data parallel", in this process: a one-rank
    NCCL group (a file store). A resident chunk of ``k`` graphed steps at
    batch TRAIN_BATCH from the state ``start``, its CUDA graph holding the
    sharded step's all-reduces, against the unsharded graphed chunk:
    params, moments and metrics bit for bit. Then the sharded decode of
    ``inputs`` through kernel 2 (``params``, ``config``): ``decoded``'s
    outputs, bit for bit. Prints each part's wall time beside the
    unsharded one's; returns the unsharded decode's (ms)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from multimodal_seq2seq_gscan_tpu_torch.decode import greedy
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    from multimodal_seq2seq_gscan_tpu_torch.parallel.mesh import (
        make_mesh, shard_batch)
    from multimodal_seq2seq_gscan_tpu_torch.train import resident
    from multimodal_seq2seq_gscan_tpu_torch.train.state import Adam
    store = tempfile.mkdtemp(prefix="gscan_chip_smoke_nccl_")
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        store, "store"), world_size=1, rank=0)
    try:
        mesh = make_mesh()
        require(mesh.backend == "nccl" and mesh.shape == (1, 1),
                "mesh {} over {}".format(mesh.shape, mesh.backend))
        optimizer = Adam()
        data = resident.build_resident_data(train_set, DEVICE)
        block = next(resident.index_block_stream(
            data.num_examples, TRAIN_BATCH, k, np.random.default_rng(SEED)))
        chunks = {"sharded": resident.make_train_chunk(
            train_config, optimizer, mesh=mesh),
            "unsharded": resident.make_train_chunk(train_config, optimizer)}
        results, first_s, launches = {}, {}, {}
        for name, chunk in chunks.items():
            tf.launches.update({kernel: 0 for kernel in tf.launches})
            begin = time.perf_counter()
            results[name] = chunk(start, data, block)
            sync()
            first_s[name] = time.perf_counter() - begin
            launches[name] = dict(tf.launches)
        (a, a_metrics), (b, b_metrics) = results["sharded"], \
            results["unsharded"]
        same = (all(torch.equal(a_metrics[name], b_metrics[name])
                    for name in resident.METRIC_NAMES)
                and leaves_equal(a.params, b.params)
                and leaves_equal(a.opt_state.mu, b.opt_state.mu)
                and leaves_equal(a.opt_state.nu, b.opt_state.nu))
        replay_ms = {name: cuda_ms(lambda chunk=chunk: chunk(start, data,
                                                             block),
                                   3, warmup=1) / k
                     for name, chunk in chunks.items()}
        print("{}, resident chunk (K={}, B={}): params, moments and metrics "
              "against the unsharded chunk: {}; losses {}".format(
                  label, k, TRAIN_BATCH,
                  "bit for bit" if same else "DIFFER",
                  ["{:.6f}".format(float(x)) for x in a_metrics["loss"]]))
        print("{}, resident chunk: first call (warm-up and capture) {:.3f} "
              "s against the unsharded {:.3f} s; replay {:.3f} ms a step "
              "against {:.3f} ms; launches while captured: {} (unsharded "
              "{})".format(label, first_s["sharded"], first_s["unsharded"],
                           replay_ms["sharded"], replay_ms["unsharded"],
                           launches["sharded"], launches["unsharded"]))
        require(same, "{}: the chunk differs from the unsharded "
                "chunk".format(label))
        require(all(count > 0 for count in launches["sharded"].values()),
                "{}: a teacher-forced kernel was not launched in the sharded "
                "chunk".format(label))
        decode = greedy.make_greedy_decoder(
            config, MAX_DECODING_STEPS, EXIT_CHECK_EVERY,
            decode_impl="block", mesh=mesh)
        unsharded = greedy.make_greedy_decoder(
            config, MAX_DECODING_STEPS, EXIT_CHECK_EVERY,
            decode_impl="block")
        k2.launches = 0
        out = decode(params, *shard_batch(mesh, inputs))
        sync()
        launches_decode = k2.launches
        times = {}
        for name, fn in (("sharded", decode), ("unsharded", unsharded)):
            begin = time.perf_counter()
            fn(params, *inputs)
            sync()
            times[name] = (time.perf_counter() - begin) * 1e3
        same = all(torch.equal(getattr(out, name), getattr(decoded, name))
                   for name in ("tokens", "emitted_mask", "lengths",
                                "attention_commands",
                                "attention_situations"))
        print("{}, decode of {} (kernel 2, {} launches): every output "
              "against the unsharded decode's: {}; {:.3f} ms against the "
              "unsharded {:.3f} ms (wall clock)".format(
                  label, len(inputs[0]), launches_decode,
                  "bit for bit" if same else "DIFFER", times["sharded"],
                  times["unsharded"]))
        require(launches_decode > 0, "{}: the sharded decode did not launch "
                "kernel 2".format(label))
        require(same, "{}: the sharded decode differs from the unsharded "
                "decode".format(label))
        return times["unsharded"]
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def _data_parallel_rank(mesh, last, out_dir):
    """One rank's part of phase (b) (``parallel/launch.py``, two ranks on
    the card over gloo): the streamed ``train()`` from the fixture
    checkpoint to step ``last``; the sharded decode of the BATCH dev
    examples (kernel 2); ``predict_and_save`` of DP_PREDICT_EXAMPLES
    into ``out_dir``. Returns what rank 0 saw (every rank's param
    sums, gathered), the launch counts and the wall times."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
        GroundedScanDataset)
    from multimodal_seq2seq_gscan_tpu_torch.decode import greedy
    from multimodal_seq2seq_gscan_tpu_torch.decode.predict import (
        predict_and_save)
    from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
    from multimodal_seq2seq_gscan_tpu_torch.models.params import leaves
    from multimodal_seq2seq_gscan_tpu_torch.ops import additive_attention \
        as k1
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    from multimodal_seq2seq_gscan_tpu_torch.parallel.mesh import (
        gather_rows, shard_batch)
    from multimodal_seq2seq_gscan_tpu_torch.train.checkpoint import (
        load_params)
    from multimodal_seq2seq_gscan_tpu_torch.train.loop import train
    seen, times = {"events": []}, {}
    k1.launches, k2.launches = 0, 0
    tf.launches.update({name: 0 for name in tf.launches})
    begin = time.perf_counter()
    state, _ = train(
        str(FIXTURE / "dataset.txt"), str(FIXTURE),
        training_batch_size=TRAIN_BATCH,
        resume_from_file=str(FIXTURE / "model_best.msgpack"),
        max_training_iterations=last, print_every=PRINT_EVERY,
        evaluate_every=last, output_directory=os.path.join(out_dir, "train"),
        max_testing_examples=STEP_EXAMPLES, seed=SEED, steps_per_execution=1,
        device=mesh.device, mesh=mesh,
        callback=lambda *event: seen["events"].append(event))
    torch.cuda.synchronize()
    times["train"] = time.perf_counter() - begin
    seen["launches_train"] = dict(tf.launches, decode_block=k2.launches,
                                  additive_attention=k1.launches)
    seen["step"] = state.step
    seen["params"] = [t.cpu() for t in leaves(state.params)]
    seen["param_sums"] = gather_rows(mesh, torch.stack(
        [t.double().sum() for t in leaves(state.params)])[None]).cpu()

    dataset = GroundedScanDataset(str(FIXTURE / "dataset.txt"), str(FIXTURE),
                                  split="dev")
    dataset.read_dataset(max_examples=BATCH)
    config = ModelConfig(
        input_vocabulary_size=dataset.input_vocabulary_size,
        target_vocabulary_size=dataset.target_vocabulary_size,
        num_cnn_channels=dataset.image_channels)
    params = load_params(str(FIXTURE / "model_best.msgpack"),
                         device=mesh.device)
    batch = next(dataset.get_data_iterator(
        batch_size=BATCH, pad_to_full_batch=True,
        with_representations=False))[0]
    rows = shard_batch(mesh, (batch.input_ids, batch.input_lengths,
                              batch.situations, batch.target_positions))
    rows = [t.to(mesh.device) for t in rows]
    decode = greedy.make_greedy_decoder(config, MAX_DECODING_STEPS,
                                        EXIT_CHECK_EVERY, decode_impl="block",
                                        mesh=mesh)
    decode(params, *rows)
    torch.cuda.synchronize()
    k2.launches = 0
    begin = time.perf_counter()
    out = decode(params, *rows)
    torch.cuda.synchronize()
    times["decode"] = time.perf_counter() - begin
    seen["launches_decode"] = k2.launches
    seen["decode"] = {name: getattr(out, name).cpu() for name in (
        "tokens", "emitted_mask", "lengths")}

    small = GroundedScanDataset(str(FIXTURE / "dataset.txt"), str(FIXTURE),
                                split="dev")
    small.read_dataset(max_examples=DP_PREDICT_EXAMPLES)
    begin = time.perf_counter()
    predict_and_save(small, params, config,
                     os.path.join(out_dir, "predict.json"),
                     MAX_DECODING_STEPS, batch_size=DP_PREDICT_EXAMPLES,
                     mesh=mesh)
    times["predict"] = time.perf_counter() - begin
    seen["times"] = times
    return seen


def dryrun_entry_check():
    """``parallel/dryrun.py``'s ``entry()`` puts its params and batch on the
    card by default; its loss there is held to the same call's on the CPU
    (rtol 1e-5, the tests' bar against JAX's loss)."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.parallel import dryrun
    fn, (params, batch) = dryrun.entry()
    require(params.encoder.embedding.is_cuda and batch.input_ids.is_cuda,
            "entry() did not put its arguments on the card")
    got = float(fn(params, batch))
    cpu_fn, (cpu_params, cpu_batch) = dryrun.entry(device="cpu")
    want = float(cpu_fn(cpu_params, cpu_batch))
    print("dryrun.entry() on the card: loss {:.7f}, on the CPU {:.7f}"
          .format(got, want))
    require(math.isfinite(got) and abs(got - want) <= 1e-5 * abs(want),
            "entry()'s loss on the card differs from the CPU's")


def data_parallel_two_ranks(params, config, decoded, plain_out, single,
                            single_decode_ms):
    """Phase (b) of "main path: data parallel": two ranks sharing the card
    over gloo (NCCL refuses two ranks on one device), started by
    ``parallel/launch.py``. Held to the single process: the streamed
    ``train()`` of TRAIN_STEPS steps at batch TRAIN_BATCH (TRAIN_BATCH / 2
    rows a rank; kernels 3, 4 and the helper), its logged losses atol
    1e-5 and params rtol 3e-4 / atol 3e-5 (kernel 4's end-to-end bars)
    against the train phase's run, both ranks' params bit for bit alike;
    the sharded decode of the BATCH dev examples (BATCH / 2 a rank,
    kernel 2): the decode phase's tokens under the near-tie rule; and
    ``predict_and_save`` of DP_PREDICT_EXAMPLES examples: the single
    process's predict.json at the ranks' batch byte for byte, and at the
    whole batch every field but the attention weights equal, those at
    rtol 1e-5 / atol 1e-6. ``single``: the train phase's
    (state, train events, wall seconds); ``single_decode_ms``: the
    unsharded decode's wall time."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
        GroundedScanDataset)
    from multimodal_seq2seq_gscan_tpu_torch.decode.greedy import (
        GreedyDecodeOutput)
    from multimodal_seq2seq_gscan_tpu_torch.decode.predict import (
        predict_and_save)
    from multimodal_seq2seq_gscan_tpu_torch.models.params import leaves
    from multimodal_seq2seq_gscan_tpu_torch.parallel.launch import launch
    single_state, single_events, single_train_s = single
    last = single_state.step - 1
    out_dir = tempfile.mkdtemp(prefix="gscan_chip_smoke_ranks_")
    try:
        begin = time.perf_counter()
        seen = launch(_data_parallel_rank, 2, last, out_dir, device=DEVICE,
                      share_device=True)
        launch_s = time.perf_counter() - begin
        with open(os.path.join(out_dir, "predict.json"), "rb") as f:
            sharded_json = f.read()
        small = GroundedScanDataset(str(FIXTURE / "dataset.txt"),
                                    str(FIXTURE), split="dev")
        small.read_dataset(max_examples=DP_PREDICT_EXAMPLES)
        single_json, single_predict_s = {}, {}
        for batch in (DP_PREDICT_EXAMPLES, DP_PREDICT_EXAMPLES // 2):
            path = os.path.join(out_dir, "single_{}.json".format(batch))
            begin = time.perf_counter()
            predict_and_save(small, params, config, path, MAX_DECODING_STEPS,
                             batch_size=batch, device=DEVICE)
            single_predict_s[batch] = time.perf_counter() - begin
            with open(path, "rb") as f:
                single_json[batch] = f.read()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    times = seen["times"]
    print("two ranks on the card over gloo: launch {:.2f} s in all".format(
        launch_s))
    print("launches on rank 0: training {}; decode {} (kernel 2)".format(
        seen["launches_train"], seen["launches_decode"]))
    require(all(seen["launches_train"][name] > 0 for name in (
                "teacher_forced_forward", "teacher_forced_backward",
                "teacher_forced_weight_grads", "decode_block"))
            and seen["launches_decode"] > 0,
            "a kernel of the data-parallel path was not launched")

    # Training.
    losses = [v["loss"] for kind, _, v in seen["events"] if kind == "train"]
    want = [v["loss"] for kind, _, v in single_events if kind == "train"]
    loss_err = max(abs(x - y) for x, y in zip(losses, want))
    param_err = max(check_close_quiet(got.to(DEVICE), ref, 3e-4, 3e-5,
                                      "two-rank train params")
                    for got, ref in zip(seen["params"],
                                        leaves(single_state.params)))
    sums = seen["param_sums"]
    print("two-rank train() of {} steps: logged losses {} against {} (max "
          "|err| {:.3e}, atol 1e-5); params max |err| {:.3e} (rtol 3e-4, "
          "atol 3e-5); the ranks' params {}; evaluations {}".format(
              len(want) * PRINT_EVERY, ["{:.6f}".format(x) for x in losses],
              ["{:.6f}".format(x) for x in want], loss_err, param_err,
              "alike" if torch.equal(sums[0], sums[1]) else "DIFFER",
              [v for kind, _, v in seen["events"] if kind == "eval"]))
    require(len(losses) == len(want) and loss_err <= 1e-5,
            "two-rank training losses differ")
    require(seen["step"] == single_state.step, "two-rank step {}".format(
        seen["step"]))
    require(torch.equal(sums[0], sums[1]), "the ranks' params differ")

    # Decode.
    out = GreedyDecodeOutput(
        tokens=seen["decode"]["tokens"].to(DEVICE),
        emitted_mask=seen["decode"]["emitted_mask"].to(DEVICE),
        lengths=seen["decode"]["lengths"].to(DEVICE),
        attention_commands=None, attention_situations=None,
        position_accuracy=None)
    same = torch.equal(out.tokens, decoded.tokens)
    ties = check_divergences(
        "two-rank decode of {} vs plain".format(BATCH),
        decode_divergences(out, plain_out, BATCH))
    print("two-rank decode: tokens {} the decode phase's ({} near-ties)"
          .format("equal to" if same else "differ from", ties))

    # predict.json: byte for byte the single process's at the ranks'
    # batch (the shapes each rank decodes); at the whole batch, the card's
    # products take other algorithms (cuBLAS and cuDNN pick them by the
    # batch, kernel 2 splits keys by the rows attending), so the attention
    # weights part in their last bits: held there to the predict test's
    # bars (tests/test_torch_predict.py), every other field equal.
    half = DP_PREDICT_EXAMPLES // 2
    print("two-rank predict.json of {} examples at batch {} ({} a rank): "
          "{} bytes; against the single process's at batch {}: {}; at "
          "batch {}: {}".format(
              DP_PREDICT_EXAMPLES, DP_PREDICT_EXAMPLES, half,
              len(sharded_json), half,
              "byte-equal" if sharded_json == single_json[half]
              else "DIFFERENT", DP_PREDICT_EXAMPLES,
              "byte-equal" if sharded_json == single_json[DP_PREDICT_EXAMPLES]
              else "not byte-equal"))
    require(sharded_json == single_json[half],
            "the two-rank predict.json differs from the single process's at "
            "the ranks' batch")
    got = json.loads(sharded_json)
    want = json.loads(single_json[DP_PREDICT_EXAMPLES])
    require(len(got) == len(want) == DP_PREDICT_EXAMPLES,
            "predict.json holds {} and {} records".format(len(got),
                                                          len(want)))
    worst = {}
    for record, ref in zip(got, want):
        require(list(record) == list(ref) and all(
            record[k] == ref[k] for k in (
                "input", "prediction", "target", "derivation", "situation",
                "accuracy", "exact_match")),
            "a two-rank predict.json record differs from the single "
            "process's at batch {}".format(DP_PREDICT_EXAMPLES))
        for key in ("position_accuracy", "attention_weights_input",
                    "attention_weights_situation"):
            a = torch.tensor(record[key], dtype=torch.float64)
            b = torch.tensor(ref[key], dtype=torch.float64)
            require(a.shape == b.shape, "{} shapes differ".format(key))
            worst[key] = max(worst.get(key, 0.0), check_close_quiet(
                a, b, 1e-5, 1e-6, "two-rank predict.json " + key)
                if a.numel() else 0.0)
    print("two-rank predict.json against the single process's at batch {}: "
          "every word, derivation, situation and accuracy equal; max |err| "
          "{} (rtol 1e-5, atol 1e-6)".format(
              DP_PREDICT_EXAMPLES, ", ".join(
                  "{} {:.3e}".format(k, v) for k, v in worst.items())))
    print("wall time, two ranks (in the ranks) against one process: "
          "train() {:.3f} s against {:.3f} s; decode of {} {:.3f} ms "
          "against {:.3f} ms; predict_and_save of {} {:.3f} s against "
          "{:.3f} s".format(
              times["train"], single_train_s, BATCH, times["decode"] * 1e3,
              single_decode_ms,
              DP_PREDICT_EXAMPLES, times["predict"],
              single_predict_s[DP_PREDICT_EXAMPLES]))


def check_close_quiet(got, want, rtol, atol, label):
    """Max |err|; fails past atol + rtol|want|."""
    diff = (got - want).abs()
    require(bool((diff <= atol + rtol * want.abs()).all()),
            "{} disagrees with the plain version".format(label))
    return float(diff.max())


def check_close(label, got, want, rtol, atol):
    """``check_close_quiet``, printed."""
    diff = (got - want).abs()
    print("{}: max |err| {:.3e} (rtol {:g}, atol {:g})".format(
        label, float(diff.max()), rtol, atol))
    return check_close_quiet(got, want, rtol, atol, label)


def leaves_equal(a, b):
    """Every tensor of two params trees bit-identical."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.models.params import leaves
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def main():
    # Deterministic cuBLAS (for the training comparison) needs a fixed
    # workspace, set before the first cuBLAS call.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
        GroundedScanDataset)
    from multimodal_seq2seq_gscan_tpu_torch.decode import greedy
    from multimodal_seq2seq_gscan_tpu_torch.models import model
    from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
    from multimodal_seq2seq_gscan_tpu_torch.ops import _build
    from multimodal_seq2seq_gscan_tpu_torch.ops import additive_attention as k1
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    from multimodal_seq2seq_gscan_tpu_torch.models.params import leaves
    from multimodal_seq2seq_gscan_tpu_torch.train.checkpoint import (
        load_checkpoint, load_params)
    from multimodal_seq2seq_gscan_tpu_torch.train.loop import (
        epoch_stream, train)
    from multimodal_seq2seq_gscan_tpu_torch.train.state import Adam
    from multimodal_seq2seq_gscan_tpu_torch.train.step import (
        loss_and_grads, train_step)
    from multimodal_seq2seq_gscan_tpu_torch.utils.precision import (
        full_float32)

    device = torch.device(DEVICE)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    total_start = time.perf_counter()

    with phase("device"):
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = nvidia_smi_line()
        # Not set here: the entry points run in full float32 on their own
        # (checked on the main path), and the phases that call the model's
        # pieces or the plain versions directly run under full_float32().
        print("TF32 flags of the process: matmul {}, cuDNN {}".format(
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32))
        print("torch {} (CUDA {}), python {}".format(
            torch.__version__, torch.version.cuda, sys.version.split()[0]))
        print("device: {} x{}".format(kind, count))
        print(smi)

    with phase("build kernels"):
        _build.library()
        print("library: {}".format(_build.library_path))
        print("build seconds: {:.2f}".format(_build.build_seconds))
        for line in _build.build_log.splitlines():
            if any(word in line for word in ("registers", "spill", "error",
                                             "compiled in")):
                print("  ptxas: " + line.strip())

    with phase("load fixture"), full_float32():
        dataset = GroundedScanDataset(str(FIXTURE / "dataset.txt"),
                                      str(FIXTURE), split="dev")
        dataset.read_dataset(max_examples=BATCH)
        config = ModelConfig(
            input_vocabulary_size=dataset.input_vocabulary_size,
            target_vocabulary_size=dataset.target_vocabulary_size,
            num_cnn_channels=dataset.image_channels)
        params = load_params(str(FIXTURE / "model_best.msgpack"),
                             device=device)
        batch, indices, _, _ = next(dataset.get_data_iterator(
            batch_size=BATCH, pad_to_full_batch=True,
            with_representations=False))
        batch = batch.to(device)
        require(len(indices) == BATCH, "fixture has {} dev examples, "
                "expected {}".format(len(indices), BATCH))
        block_args, block2_args = fixture_blocks(params, config, batch)
        proj_txt, cmd_mask, proj_vis, h0, c0 = block_args[:5]
        weights = block_args[7]
        m_t, m_v, hidden = proj_txt.shape[1], proj_vis.shape[1], h0.shape[1]
        vocab = weights.embedding.shape[0]
        print("examples {}, M_t {}, M_v {}, H {}, V {}; done at entry to "
              "block 2: {}".format(len(indices), m_t, m_v, hidden, vocab,
                                   int(block2_args[6].sum())))

    with phase("kernels against their plain versions"), torch.no_grad(), \
            full_float32():
        gen = torch.Generator(device=device).manual_seed(0)
        # Kernel 1, (a): the JAX attention test's inputs at a decoder step's
        # two calls (M_t masked, M_v unmasked), with that test's bars, at
        # the fixture's H and at the wide decoder's (WIDE_TRAIN_H, from a
        # generator of its own, so that the later draws are unchanged).
        gen_wide = torch.Generator(device=device).manual_seed(2)
        attention_err = max(
            hold_attention("additive_attention random M={} H={} "
                           "masked={}".format(m, h, masked),
                           random_attention_inputs(g, device, BATCH, m, h,
                                                   masked))
            for g, h in ((gen, hidden), (gen_wide, WIDE_TRAIN_H))
            for m, masked in ((m_t, True), (m_v, False)))

        # Kernel 1, (b): the fixture's inputs of the first decoder step.
        pq_txt = h0 @ weights.txt_qw
        ctx_cmd, _ = k1.additive_attention_plain(pq_txt, proj_txt, cmd_mask,
                                                 weights.txt_ew)
        visual_query = torch.tanh(torch.cat([h0, ctx_cmd], dim=-1)
                                  @ weights.q2k_w + weights.q2k_b)
        pq_vis = (visual_query @ weights.vis_qw).contiguous()
        attention_calls = [(pq_txt, proj_txt, cmd_mask, weights.txt_ew),
                           (pq_vis, proj_vis, None, weights.vis_ew)]
        for args in attention_calls:
            kernel = k1.additive_attention(*args)
            sync()
            plain = k1.additive_attention_plain(*args)
            exact = k1.additive_attention_plain(*as_float64(args))
            for name, got, want, truth in zip(("context", "weights"),
                                              kernel, plain, exact):
                against_float64("additive_attention fixture M={} {}".format(
                    args[1].shape[1], name), got, want, truth)

        # Kernel 1's bf16 form (bf16 keys; float32 queries, mask and energy
        # vector as in a bfloat16_keys decode, or bf16 as in a bfloat16
        # one) against its plain version on the same inputs: the JAX
        # test's inputs at the decode's shapes, at W3's and at the wide
        # decoder's, at the float32 form's bars and the float64 referee; the
        # fixture's first decoder step, as the float32 form's, against
        # float64.
        def bf16_label(args):
            return "additive_attention bf16 M={} H={} {} queries".format(
                args[1].shape[1], args[1].shape[2],
                "bf16" if args[0].dtype == torch.bfloat16 else "float32")

        # A generator of its own, so that the draws of the phases after
        # this one are those of the runs before the bf16 form.
        gen_bf16 = torch.Generator(device=device).manual_seed(1)
        attention_bf16_err = max(
            hold_attention(bf16_label(args), args) for args in (
                as_bf16(random_attention_inputs(gen_bf16, device, BATCH, m,
                                                h, masked), small)
                for m, h, masked in ((m_t, hidden, True),
                                     (m_v, hidden, False), (72, 256, True),
                                     (144, 256, False),
                                     (m_t, WIDE_TRAIN_H, True),
                                     (m_v, WIDE_TRAIN_H, False))
                for small in (torch.float32, torch.bfloat16)))
        for small in (torch.float32, torch.bfloat16):
            for args in attention_calls:
                args = as_bf16(args, small)
                kernel = k1.additive_attention(*args)
                sync()
                plain = k1.additive_attention_plain(*args)
                exact = k1.additive_attention_plain(*as_float64(args))
                for name, got, want, truth in zip(("context", "weights"),
                                                  kernel, plain, exact):
                    against_float64("{} fixture {}".format(
                        bf16_label(args), name), got, want, truth)

        # Kernel 2, (a): weights drawn as the JAX package initialises them,
        # one block of K=32 steps from SOS and one entered with 90% of the
        # rows done (as a decode's second block is), the JAX decode test's
        # bars (its attention bar applied to the carried h and c as well).
        block_err = max(
            hold_decode_block(label, random_block_inputs(
                gen, device, BATCH, m_t, m_v, hidden, vocab,
                config.target_sos_idx, done_fraction),
                config.target_eos_idx)[0]
            for label, done_fraction in (
                ("decode_block random", 0.0),
                ("decode_block random, 90% done at entry", 0.9)))

        # Kernel 2, (b): the fixture's two blocks of K=32 steps, from SOS
        # and from the plain version's state after the first, held to
        # float64: on the fixture float32 rounding alone puts the plain
        # version about ten times the JAX bars from float64.
        block_row_steps = [
            hold_decode_block("decode_block fixture block {}".format(i + 1),
                              args, config.target_eos_idx, bars=False)[1]
            for i, args in enumerate((block_args, block2_args))]
        print("emitting row-steps of the fixture's blocks: {}".format(
            block_row_steps))

    with phase("teacher-forced kernels against their plain versions"), \
            torch.no_grad(), full_float32():
        # (a) The JAX tests' input distribution at the training shapes,
        # B=200 with T=56 (3 pad steps past num_steps=53) and T=53, at the
        # JAX tests' bars; each kernel runs twice.
        tf_err = {"forward": 0.0, "backward": 0.0, "helper": 0.0}
        for steps, num_steps in ((TRAIN_T - 3, TRAIN_T - 3),
                                 (TRAIN_T, TRAIN_T - 3)):
            inputs, (dlogits, g_asum) = random_teacher_forced_inputs(
                gen, device, TRAIN_BATCH, steps, num_steps, m_t, m_v,
                hidden, vocab, config.target_sos_idx)
            for key, err in hold_teacher_forced(
                    "teacher_forced random T={} num_steps={}".format(
                        steps, num_steps),
                    inputs, dlogits, g_asum, num_steps).items():
                tf_err[key] = max(tf_err[key], err)
            random_tf = (inputs, dlogits, g_asum, num_steps)

        # (b) The fixture's train split against float64, nine witnesses: its
        # three batches in file order, each with three decoder dropout masks.
        # Seed 0 takes the cotangent of the fixture's own training loss (NLL;
        # it trains without the aux task); seeds 1 and 2 add an N(0, 1/B)
        # cotangent on the summed attention, as the aux loss would. Held for
        # every output and gradient, by hold_witnesses: the whole unroll
        # (logits at target positions and at all T, the summed attention
        # over all T, the 16 gradients), and one step from the float64
        # unroll's state at every (t, row), where no chain amplifies the
        # rounding (logits, new h and c, the step's visual attention, the 16
        # gradients of that step).
        train_set = GroundedScanDataset(str(FIXTURE / "dataset.txt"),
                                        str(FIXTURE), split="train")
        train_set.read_dataset()
        unrolled, one_step = {}, {}
        names = ["d" + n for n in GRAD_NAMES]
        pad_idx = config.target_pad_idx
        for train_batch, _, _, _ in train_set.get_data_iterator(
                batch_size=TRAIN_BATCH, pad_to_full_batch=True,
                with_representations=False):
            train_batch = train_batch.to(device)
            encoded = model.encode_input(
                params, config, train_batch.input_ids,
                train_batch.input_lengths, train_batch.situations)
            f_txt, f_vis = (x.contiguous() for x in
                            model.project_keys(params, encoded))
            f_mask = encoded.command_mask.contiguous()
            f_h0 = model.initialize_decoder_hidden(
                params, config, encoded.hidden)[0][0].contiguous()
            f_tokens = train_batch.target_ids.T.to(torch.int32).contiguous()
            f_steps = f_tokens.shape[0]
            scored = (torch.arange(f_steps, device=device)[:, None]
                      < train_batch.target_lengths[None, :])[..., None]
            for seed in range(3):
                wgen = torch.Generator(device=device).manual_seed(seed)
                f_drop = model.decoder_drop_mask(
                    config, (f_steps, TRAIN_BATCH, hidden), device, wgen,
                    False)
                g_aux = torch.randn(TRAIN_BATCH, m_v, generator=wgen,
                                    device=device) / TRAIN_BATCH * min(seed, 1)
                fixture_tf = (f_txt, f_mask, f_vis, f_h0, f_h0.clone(),
                              f_tokens, f_drop, weights)
                exact_in = as_float64(fixture_tf)
                lg64, h64, c64, _ = tf.teacher_forced_forward_plain(
                    *exact_in, num_steps=f_steps)
                with torch.enable_grad():
                    lg = lg64.requires_grad_(True)
                    loss = model.get_loss(
                        config, torch.log_softmax(lg.transpose(0, 1), dim=-1),
                        train_batch.target_ids)
                    d_lg = torch.autograd.grad(loss, lg)[0].float()
                cot = (d_lg.contiguous(), g_aux)
                got_out, got_grads, _ = kernel_unroll(fixture_tf, *cot,
                                                      f_steps)
                sync()
                plain_out, plain_grads = plain_unroll(fixture_tf, *cot,
                                                      f_steps)
                exact_out, exact_grads = plain_unroll(
                    exact_in, *as_float64(cot), f_steps)
                for name, got, want, truth in zip(
                        ["logits (t < target length)", "logits (all T)",
                         "summed attention (all T)"] + names,
                        [got_out[0] * scored, got_out[0], got_out[1]]
                        + got_grads,
                        [plain_out[0] * scored, plain_out[0], plain_out[1]]
                        + plain_grads,
                        [exact_out[0] * scored, exact_out[0], exact_out[1]]
                        + exact_grads):
                    unrolled.setdefault(name, []).append(
                        error_ratio(got, want, truth))

                # One step from the float64 state at each (t, row): T x B
                # rows of a two-step unroll whose second step is padding
                # with no cotangent, so its outputs are step t's alone.
                rows = f_steps * TRAIN_BATCH
                idx = torch.arange(TRAIN_BATCH, device=device).repeat(f_steps)

                def two(first, second):
                    return torch.stack([first, second]).contiguous()

                step_in = (
                    f_txt[idx], f_mask[idx], f_vis[idx],
                    h64.reshape(rows, hidden).float(),
                    c64.reshape(rows, hidden).float(),
                    two(f_tokens.reshape(rows), torch.full_like(
                        f_tokens.reshape(rows), pad_idx)),
                    two(f_drop.reshape(rows, -1),
                        torch.ones_like(f_drop.reshape(rows, -1))),
                    weights)
                step_cot = (two(d_lg.reshape(rows, vocab),
                                torch.zeros(rows, vocab, device=device)),
                            g_aux[idx])
                results = []
                for args, cotangents, unroll in (
                        (step_in, step_cot, "kernel"),
                        (step_in, step_cot, "plain"),
                        (as_float64(step_in), as_float64(step_cot),
                         "plain")):
                    if unroll == "kernel":
                        (lg_s, asum_s), grads_s, (_, h_s, c_s) = \
                            kernel_unroll(args, *cotangents, 1)
                        sync()
                    else:
                        (lg_s, asum_s), grads_s = plain_unroll(
                            args, *cotangents, 1)
                        _, h_s, c_s, _ = tf.teacher_forced_forward_plain(
                            *args, num_steps=1)
                    results.append([lg_s[0] * scored.reshape(rows, 1),
                                    lg_s[0], h_s[1], c_s[1], asum_s]
                                   + list(grads_s))
                for name, got, want, truth in zip(
                        ["logits (t < target length)", "logits (all T)",
                         "new h", "new c", "visual attention"]
                        + names, *results):
                    one_step.setdefault(name, []).append(
                        error_ratio(got, want, truth))
                del step_in, step_cot, results
        hold_witnesses("teacher_forced fixture, one step:", one_step)
        hold_witnesses("teacher_forced fixture, whole unroll:", unrolled)

    with phase("kernels at wide shapes against their plain versions"), \
            torch.no_grad(), full_float32():
        wide_rows = wide_shape_rows(gen, device, vocab,
                                    config.target_sos_idx,
                                    config.target_eos_idx)
        wide_rows += past_448_rows(gen, device, vocab, config.target_sos_idx,
                                   config.target_eos_idx)
        wide_rows += wide_teacher_forced_rows(gen, device, vocab,
                                              config.target_sos_idx)
        print("wide shapes: {}".format(json.dumps(wide_rows)))

    tf32_seen = set()
    with phase("main path: decode {} fixture dev examples".format(BATCH)), \
            encoder_precision(tf32_seen):
        decode_kernel = greedy.make_greedy_decoder(
            config, MAX_DECODING_STEPS, EXIT_CHECK_EVERY, decode_impl="block")
        decode_plain = greedy.make_greedy_decoder(
            config, MAX_DECODING_STEPS, EXIT_CHECK_EVERY,
            decode_impl="block_plain")
        decode_step = greedy.make_greedy_decoder(
            config, MAX_DECODING_STEPS, EXIT_CHECK_EVERY, decode_impl="step")
        inputs = (batch.input_ids, batch.input_lengths, batch.situations,
                  batch.target_positions)

        k1.launches, k2.launches = 0, 0
        kernel_out = decode_kernel(params, *inputs)
        sync()
        launches_block = {"decode_block": k2.launches,
                          "additive_attention": k1.launches}
        plain_out = decode_plain(params, *inputs)
        sync()
        k1.launches, k2.launches = 0, 0
        step_out = decode_step(params, *(x[:STEP_EXAMPLES] for x in inputs))
        sync()
        launches_step = {"decode_block": k2.launches,
                         "additive_attention": k1.launches}
        print("launches, block decode: {}; step decode: {}".format(
            launches_block, launches_step))
        require(launches_block["decode_block"] > 0
                and launches_step["additive_attention"] > 0,
                "a kernel of the main path was not launched")

        for label, output, rows in (("block decode", kernel_out, BATCH),
                                    ("plain decode", plain_out, BATCH),
                                    ("step decode", step_out, STEP_EXAMPLES)):
            shape = tuple(output.tokens.shape)
            require(shape == (rows, MAX_DECODING_STEPS + 1),
                    "{} tokens have shape {}".format(label, shape))
            for name in ("attention_commands", "attention_situations"):
                require(bool(torch.isfinite(getattr(output, name)).all()),
                        "{} {} not finite".format(label, name))
        ties_block = check_divergences(
            "block decode vs plain", decode_divergences(kernel_out, plain_out,
                                                        BATCH))
        ties_step = check_divergences(
            "step decode vs plain (first {})".format(STEP_EXAMPLES),
            decode_divergences(step_out, plain_out, STEP_EXAMPLES))
        eos = config.target_eos_idx
        em_kernel = exact_match(kernel_out, dataset, indices, eos)
        em_plain = exact_match(plain_out, dataset, indices, eos)
        em_step = exact_match(step_out, dataset, indices[:STEP_EXAMPLES], eos)
        em_plain_512 = exact_match(
            greedy.GreedyDecodeOutput(*(x[:STEP_EXAMPLES] for x in plain_out)),
            dataset, indices[:STEP_EXAMPLES], eos)
        print("exact match: block (kernel 2) {:.4f}%, plain {:.4f}% over {}; "
              "step (kernel 1) {:.4f}%, plain {:.4f}% over the first "
              "{}".format(em_kernel, em_plain, BATCH, em_step, em_plain_512,
                          STEP_EXAMPLES))
        require(em_kernel > 90.0, "the trained fixture decodes at only "
                "{:.2f}% exact match".format(em_kernel))
        print("decoded steps: {} of {}; emitted tokens: {}".format(
            int(kernel_out.emitted_mask.sum(0).gt(0).sum()),
            MAX_DECODING_STEPS + 1, int(kernel_out.lengths.sum())))

    with phase("main path: bf16 decodes of {} fixture dev examples".format(
            BATCH)), encoder_precision(tf32_seen):
        launches_bf16, _ = bf16_decodes(params, config, inputs, dataset,
                                        indices, kernel_out, plain_out,
                                        em_kernel, sync)

    with phase("main path: predict {} fixture dev examples".format(BATCH)), \
            encoder_precision(tf32_seen):
        predict_checks("predict", dataset, params, config, kernel_out,
                       em_kernel, inputs, decode_kernel, sync, BATCH)

    with phase("main path: train {} steps at batch {} from the fixture "
               "checkpoint".format(TRAIN_STEPS, TRAIN_BATCH)), \
            encoder_precision(tf32_seen):
        start = 200000
        last = start + TRAIN_STEPS - 1
        events = []

        def report(kind, iteration, values):
            events.append((kind, iteration, values))
            print("{} {}: {}".format(kind, iteration, ", ".join(
                "{} {:.6g}".format(k, v) for k, v in values.items())))

        out_dir = tempfile.mkdtemp(prefix="gscan_chip_smoke_")
        try:
            k1.launches, k2.launches = 0, 0
            tf.launches.update({name: 0 for name in tf.launches})
            train_start = time.perf_counter()
            state, train_config = train(
                str(FIXTURE / "dataset.txt"), str(FIXTURE),
                training_batch_size=TRAIN_BATCH,
                resume_from_file=str(FIXTURE / "model_best.msgpack"),
                max_training_iterations=last, print_every=PRINT_EVERY,
                evaluate_every=last, output_directory=out_dir,
                max_testing_examples=STEP_EXAMPLES, seed=SEED,
                steps_per_execution=1, device=device, callback=report)
            sync()
            single_train = (state, list(events),
                            time.perf_counter() - train_start)
            launches_train = dict(tf.launches, decode_block=k2.launches,
                                  additive_attention=k1.launches)
            print("launches, training: {}".format(launches_train))
            require(all(launches_train[name] == TRAIN_STEPS
                        for name in tf.launches),
                    "a teacher-forced kernel was not launched once per step")
            require(launches_train["decode_block"] > 0,
                    "the dev evaluation did not run kernel 2")
            train_losses = [v["loss"] for kind, _, v in events
                            if kind == "train"]
            evaluations = [v for kind, _, v in events if kind == "eval"]
            require(len(train_losses) == TRAIN_STEPS // PRINT_EVERY
                    and all(math.isfinite(x) and x < 1.0
                            for x in train_losses),
                    "training losses: {}".format(train_losses))
            require(len(evaluations) == 1
                    and evaluations[0]["exact_match"] > 90.0,
                    "dev evaluation: {}".format(evaluations))
            require(state.step == start + TRAIN_STEPS,
                    "state step {}".format(state.step))
            written, meta = load_checkpoint(
                os.path.join(out_dir, "checkpoint.msgpack"), device=device)
            same = (leaves_equal(written.params, state.params)
                    and leaves_equal(written.opt_state.mu,
                                     state.opt_state.mu)
                    and leaves_equal(written.opt_state.nu,
                                     state.opt_state.nu)
                    and written.opt_state[0::3] == state.opt_state[0::3]
                    and written.step == state.step == meta["iteration"]
                    and bool((written.rng == state.rng).all()))
            print("checkpoint round trip ({}): every leaf equal: {}; "
                  "meta {}".format(sorted(os.listdir(out_dir)), same, meta))
            require(same, "the checkpoint read back differs from the state")
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)

        # The first steps again from the fixture state, through kernels 3+4
        # ("fused"), through kernel 1 ("step", one step) and the plain
        # unroll, with the same batches and dropout generators. PyTorch's
        # own backward (the encoder's, in both paths) is not deterministic
        # by default: two plain runs are measured that way first, then the
        # comparison runs with deterministic algorithms, so that it sees
        # only the kernel path's arithmetic against the plain path's.
        resumed, _ = load_checkpoint(str(FIXTURE / "model_best.msgpack"),
                                     device=device)
        stream = epoch_stream(train_set, TRAIN_BATCH,
                              np.random.default_rng(SEED))
        batches = [next(stream)[0].to(device) for _ in range(COMPARE_STEPS)]
        optimizer = Adam()
        configs = {impl: train_config._replace(teacher_forced_impl=impl)
                   for impl in ("fused", "step", "plain")}

        def trajectory(impl):
            """(per-step losses, params after step 1) of COMPARE_STEPS."""
            state, losses = resumed, []
            for i, batch_i in enumerate(batches):
                state, metrics = train_step(state, batch_i, configs[impl],
                                            optimizer)
                losses.append(float(metrics["loss"]))
                if i == 0:
                    params_1 = state.params
            return losses, params_1

        def max_rel(a, b):
            return max(abs(x - y) / abs(y) for x, y in zip(a, b))

        print("plain path run twice with PyTorch's default algorithms: "
              "per-step loss max rel difference {:.3e}".format(
                  max_rel(trajectory("plain")[0], trajectory("plain")[0])))
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
        try:
            first = {impl: loss_and_grads(resumed, batches[0], cfg)
                     for impl, cfg in configs.items()}
            for impl in ("fused", "step"):
                np_loss, ref_loss = float(first[impl][0]), float(
                    first["plain"][0])
                rel = abs(np_loss - ref_loss) / abs(ref_loss)
                print("step 1 {} vs plain: loss {:.8f} vs {:.8f}, rel err "
                      "{:.3e} (rtol 1e-5)".format(impl, np_loss, ref_loss,
                                                  rel))
                require(rel <= 1e-5,
                        "step-1 loss of {} differs".format(impl))
                grad_err = max(
                    check_close_quiet(g, r, 3e-4, 3e-5, impl) for g, r in
                    zip(leaves(first[impl][2]), leaves(first["plain"][2])))
                print("step 1 {} vs plain: gradients max |err| {:.3e} (rtol "
                      "3e-4, atol 3e-5)".format(impl, grad_err))
            losses, params_1 = {}, {}
            for impl in ("fused", "plain"):
                losses[impl], params_1[impl] = trajectory(impl)
            again = trajectory("fused")
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
        param_err = max(float((a - b).abs().max()) for a, b in
                        zip(leaves(params_1["fused"]),
                            leaves(params_1["plain"])))
        print("params after step 1, fused vs plain: max |err| {:.3e} (atol "
              "1e-6)".format(param_err))
        require(param_err <= 1e-6, "params after step 1 differ")
        rel = max_rel(losses["fused"], losses["plain"])
        print("per-step loss, fused {} vs plain {}: max rel err {:.3e} "
              "(rtol 1e-5); fused run again: {}".format(
                  ["{:.6f}".format(x) for x in losses["fused"]],
                  ["{:.6f}".format(x) for x in losses["plain"]], rel,
                  "bit-identical" if again[0] == losses["fused"]
                  and leaves_equal(again[1], params_1["fused"])
                  else "differs"))
        require(rel <= 1e-5, "per-step losses differ")
    with phase("main path: resident training from the fixture "
               "checkpoint"), encoder_precision(tf32_seen):
        resident_checks(train_set, train_config, events, batches[0], sync)

    with phase("main path: train at H = {}".format(WIDE_TRAIN_H)), \
            encoder_precision(tf32_seen):
        wide_training_checks(train_set, sync)

    with phase("main path: the wide decoder at H = {} through the entry "
               "points".format(WIDE_TRAIN_H)), encoder_precision(tf32_seen):
        wide_decoder_checks(train_set, dataset, smi, sync)

    with phase("main path: the command line, --mode=train and --mode=test"), \
            encoder_precision(tf32_seen):
        cli_checks("cli", dataset, config, sync,
                   str(FIXTURE / "model_best.msgpack"), 200000, 200020,
                   RESIDENT_K, 2 * RESIDENT_K, STEP_EXAMPLES, BATCH,
                   words=[dataset.array_to_sentence(seq, "target")
                          for seq in greedy.strip_output_sequences(
                              kernel_out, config.target_eos_idx)[0][
                                  :STEP_EXAMPLES]], min_exact=90.0)

    with phase("main path: a two-layer decoder's resident chunk"), \
            encoder_precision(tf32_seen):
        two_layer_checks(train_set, train_config, sync)

    with phase("main path: multi-seed training"), \
            encoder_precision(tf32_seen):
        multiseed_checks(train_set, train_config, sync)
        print(smi)

    with phase("main path: data parallel"), encoder_precision(tf32_seen):
        single_decode_ms = data_parallel_one_rank(
            train_set, train_config, load_checkpoint(
                str(FIXTURE / "model_best.msgpack"), device=device)[0],
            RESIDENT_K, params, config, inputs, kernel_out, sync)
        data_parallel_two_ranks(params, config, kernel_out, plain_out,
                                single_train, single_decode_ms)
        dryrun_entry_check()
        print(smi)

    with phase("data: native loader"), encoder_precision(tf32_seen):
        native_loader_checks(dataset, params, config, sync)
        print(smi)

    with phase("dataset engine and analysis"), encoder_precision(tf32_seen):
        engine_checks(sync)
        print(smi)

    print("TF32 flags (matmul, cuDNN) inside the entry points on the main "
          "paths: {}; outside: ({}, {})".format(
              sorted(tf32_seen), torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32))
    require(tf32_seen == {(False, False)},
            "an entry point ran PyTorch's products with TF32 allowed")

    with phase("times (CUDA events)"), torch.no_grad(), full_float32():
        def both_attention(fn):
            return lambda: [fn(*args) for args in attention_calls]

        # Launched from the host, as every kernel is timed; beside it the
        # device's time from a CUDA graph (a call takes less device time
        # than the wrapper's host time, so the host-timed figure is partly
        # the host's).
        attention_ms = cuda_ms(both_attention(k1.additive_attention), 50)
        attention_graph_ms = graph_ms(both_attention(k1.additive_attention),
                                      50)
        # The same launches through the autograd.Function, the wrapper's
        # path when a gradient is wanted: its host cost beside the direct
        # launch's.
        attention_function_ms = cuda_ms(
            both_attention(k1.AdditiveAttention.apply), 50)
        attention_plain_ms = cuda_ms(
            both_attention(k1.additive_attention_plain), 20)
        # Kernel 1's bf16 form on the same two calls, the keys in bf16:
        # float32 queries, mask and energy vector (bfloat16_keys), then
        # all bf16 (bfloat16).
        bf16_times = {}
        for small in (torch.float32, torch.bfloat16):
            calls = [as_bf16(args, small) for args in attention_calls]

            def bf16_attention(fn, calls=calls):
                return lambda: [fn(*args) for args in calls]

            small_bytes = 4 if small == torch.float32 else 2
            bf16_times[small_bytes] = (
                cuda_ms(bf16_attention(k1.additive_attention), 50),
                graph_ms(bf16_attention(k1.additive_attention), 50),
                cuda_ms(bf16_attention(k1.additive_attention_plain), 20),
                bound_ms(*(sum(x) for x in zip(
                    attention_work(BATCH, m_t, hidden, True, 2,
                                   small_bytes),
                    attention_work(BATCH, m_v, hidden, False, 2,
                                   small_bytes)))))
        weights_bytes = sum(w.numel() * 4 for w in weights)
        block_times = []  # (ms, plain ms, bound) of the fixture's blocks
        for args, row_steps in zip((block_args, block2_args),
                                   block_row_steps):
            block_times.append((
                cuda_ms(lambda: k2.fused_decode_block(
                    *args, num_steps=EXIT_CHECK_EVERY,
                    eos_idx=config.target_eos_idx), 10),
                cuda_ms(lambda: k2.decode_block_plain(
                    *args, num_steps=EXIT_CHECK_EVERY,
                    eos_idx=config.target_eos_idx), 3, warmup=1),
                bound_ms(*decode_block_work(
                    BATCH, m_t, m_v, hidden, vocab, EXIT_CHECK_EVERY,
                    weights_bytes, row_steps))))
        decode_ms = cuda_ms(lambda: decode_kernel(params, *inputs), 5,
                            warmup=1)
        decode_plain_ms = cuda_ms(lambda: decode_plain(params, *inputs), 2,
                                  warmup=1)

        def encode():
            encoded = model.encode_input(params, config, *inputs[:3])
            model.project_keys(params, encoded)
            model.initialize_decoder_hidden(params, config, encoded.hidden)

        encode_ms = cuda_ms(encode, 5, warmup=1)
        profile_decode(lambda: decode_kernel(params, *inputs), encode, sync)
        attention_bytes, attention_flops = (
            sum(x) for x in zip(attention_work(BATCH, m_t, hidden, True),
                                attention_work(BATCH, m_v, hidden, False)))
        attention_bound = bound_ms(attention_bytes, attention_flops)
        print("additive_attention (M={} masked + M={} unmasked, B={}): "
              "{:.4f} ms, plain {:.4f} ms, bound {:.4f} ms ({}); from a "
              "CUDA graph {:.4f} ms, through its autograd.Function {:.4f} "
              "ms".format(
                  m_t, m_v, BATCH, attention_ms, attention_plain_ms,
                  *attention_bound, attention_graph_ms,
                  attention_function_ms))
        for small_bytes, (ms, g_ms, plain_ms, bound) in sorted(
                bf16_times.items(), reverse=True):
            print("additive_attention bf16 form, bf16 keys and {} queries, "
                  "mask and energy vector (the same calls): {:.4f} ms, "
                  "plain {:.4f} ms, bound {:.4f} ms ({}); from a CUDA graph "
                  "{:.4f} ms".format(
                      "float32" if small_bytes == 4 else "bf16", ms,
                      plain_ms, *bound, g_ms))
        for index, (ms, plain_ms, bound) in enumerate(block_times):
            print("decode_block, the fixture's block {} (K={}, B={}, {} "
                  "emitting row-steps): {:.4f} ms, plain {:.4f} ms, bound "
                  "{:.4f} ms ({})".format(index + 1, EXIT_CHECK_EVERY, BATCH,
                                          block_row_steps[index], ms,
                                          plain_ms, *bound))
        print("full decode of {} examples: kernel path {:.3f} ms = {:.1f} "
              "ex/s; plain path {:.3f} ms = {:.1f} ex/s".format(
                  BATCH, decode_ms, BATCH / decode_ms * 1e3, decode_plain_ms,
                  BATCH / decode_plain_ms * 1e3))
        print("of which the encoder (encode_input, project_keys, initial "
              "state): {:.3f} ms; decode blocks run: {}".format(
                  encode_ms, launches_block["decode_block"]))

    with phase("times: training (CUDA events)"), torch.no_grad(), \
            full_float32():
        inputs, dlogits, g_asum, num_steps = random_tf
        steps = inputs[5].shape[0]
        _, _, (raw, h_res, c_res) = kernel_unroll(inputs, dlogits, g_asum,
                                                  num_steps)
        fwd_ms = cuda_ms(lambda: tf.teacher_forced_forward(
            *inputs, num_steps=num_steps), 20)
        bwd_ms = cuda_ms(lambda: tf.teacher_forced_backward(
            *inputs[:3], *inputs[5:], h_res, c_res, dlogits, g_asum,
            num_steps=num_steps), 10)
        helper_ms = cuda_ms(lambda: tf.teacher_forced_weight_grads(
            raw[4], h_res, dlogits), 20)
        fwd_plain_ms = cuda_ms(lambda: tf.teacher_forced_forward_plain(
            *inputs, num_steps=num_steps), 3, warmup=1)
        bwd_plain_ms = cuda_ms(lambda: tf.teacher_forced_backward_plain(
            *inputs[:3], *inputs[5:], h_res, c_res, dlogits, g_asum,
            num_steps=num_steps), 3, warmup=1)
        helper_plain_ms = cuda_ms(lambda: tf.weight_grads_plain(
            raw[4], h_res, dlogits), 10)
        fwd_work, bwd_work, helper_work = teacher_forced_work(
            TRAIN_BATCH, steps, m_t, m_v, hidden, hidden, vocab)
        fwd_bound, bwd_bound, helper_bound = (
            bound_ms(*w) for w in (fwd_work, bwd_work, helper_work))
        for name, ms, plain_ms, bound in (
                ("teacher_forced_forward (kernel 3)", fwd_ms, fwd_plain_ms,
                 fwd_bound),
                ("teacher_forced_backward (kernel 4)", bwd_ms, bwd_plain_ms,
                 bwd_bound),
                ("teacher_forced_weight_grads (helper)", helper_ms,
                 helper_plain_ms, helper_bound)):
            print("{} (B={}, T={}): {:.4f} ms, plain {:.4f} ms, bound {:.4f} "
                  "ms ({})".format(name, TRAIN_BATCH, steps, ms, plain_ms,
                                   *bound))
        # The helper's library call: its 14 products through torch.matmul
        # (cuBLAS) on operands staged beforehand, timed with the helper as
        # CUDA graphs, so that neither pays the host's cost of launching.
        operands = helper_library_operands(raw[4], h_res, dlogits,
                                           inputs[7].embedding.shape[1])
        helper_grads = tf.teacher_forced_weight_grads(raw[4], h_res, dlogits)
        for name, got, want in zip(GRAD_NAMES[4:], helper_library(operands),
                                   helper_grads):
            check_close("helper library call d" + name, got, want, 2e-4,
                        2e-5)
        helper_library_ms = graph_ms(lambda: helper_library(operands), 20)
        helper_graph_ms = graph_ms(lambda: tf.teacher_forced_weight_grads(
            raw[4], h_res, dlogits), 20)
        print("helper in a CUDA graph: {:.4f} ms; its library call (14 "
              "torch.matmul on staged operands) in a CUDA graph: {:.4f} "
              "ms".format(helper_graph_ms, helper_library_ms))
        del operands
        step_ms = {}
        for impl, repeats in (("fused", 10), ("step", 3), ("plain", 3)):
            step_ms[impl] = cuda_ms(lambda: train_step(
                resumed, batches[0], configs[impl], optimizer), repeats,
                warmup=1)
        print("train step at batch {} (T={}, dropout on, Adam): fused "
              "{:.3f} ms, step {:.3f} ms, plain {:.3f} ms".format(
                  TRAIN_BATCH, batches[0].target_ids.shape[1],
                  step_ms["fused"], step_ms["step"], step_ms["plain"]))
        print("training examples/s: fused {:.1f}, step {:.1f}, plain "
              "{:.1f}".format(*(TRAIN_BATCH / step_ms[i] * 1e3
                                for i in ("fused", "step", "plain"))))
        _, _, grads0 = loss_and_grads(resumed, batches[0], configs["fused"])
        grads_ms = cuda_ms(lambda: loss_and_grads(
            resumed, batches[0], configs["fused"]), 10, warmup=1)
        adam_ms = cuda_ms(lambda: optimizer.apply(
            resumed.params, grads0, resumed.opt_state), 10)
        print("of the fused step: forward + backward {:.3f} ms (kernels 3, "
              "4 and the helper at this T: see the profile), Adam {:.3f} "
              "ms".format(grads_ms, adam_ms))
        profile_train_step(lambda: train_step(
            resumed, batches[0], configs["fused"], optimizer), sync)

    kernels = [
        {"name": "additive_attention", "route": "cuda",
         "source": "multimodal_seq2seq_gscan_tpu_torch/csrc/"
                   "additive_attention.cu",
         "replaces": "multimodal_seq2seq_gscan_tpu/ops/pallas_attention.py:55",
         "launches": launches_step["additive_attention"],
         "max_abs_err": attention_err, "ms": attention_ms,
         "plain_ms": attention_plain_ms, "bound_ms": attention_bound[0],
         "bound_by": attention_bound[1], "library_ms": None,
         "graph_ms": attention_graph_ms},
        {"name": "additive_attention_bf16", "route": "cuda",
         "source": "multimodal_seq2seq_gscan_tpu_torch/csrc/"
                   "additive_attention.cu",
         "replaces": "multimodal_seq2seq_gscan_tpu/ops/pallas_attention.py:55",
         "launches": launches_bf16, "max_abs_err": attention_bf16_err,
         "ms": bf16_times[4][0], "plain_ms": bf16_times[4][2],
         "bound_ms": bf16_times[4][3][0], "bound_by": bf16_times[4][3][1],
         "library_ms": None, "graph_ms": bf16_times[4][1],
         "bf16_queries_ms": bf16_times[2][0],
         "bf16_queries_graph_ms": bf16_times[2][1],
         "bf16_queries_bound_ms": bf16_times[2][3][0]},
        {"name": "decode_block", "route": "cuda",
         "source": "multimodal_seq2seq_gscan_tpu_torch/csrc/decode_block.cu",
         "replaces": "multimodal_seq2seq_gscan_tpu/ops/pallas_decoder.py:149",
         "launches": launches_block["decode_block"],
         "max_abs_err": block_err, "ms": block_times[0][0],
         "plain_ms": block_times[0][1], "bound_ms": block_times[0][2][0],
         "bound_by": block_times[0][2][1], "library_ms": None,
         "block2_ms": block_times[1][0], "block2_plain_ms": block_times[1][1],
         "block2_bound_ms": block_times[1][2][0]},
    ]
    tf_source = "multimodal_seq2seq_gscan_tpu_torch/csrc/teacher_forced.cu"
    tf_replaces = "multimodal_seq2seq_gscan_tpu/ops/pallas_teacher_forced.py"
    for name, line, err, ms, plain_ms, bound, library_ms in (
            ("teacher_forced_forward", 164, tf_err["forward"], fwd_ms,
             fwd_plain_ms, fwd_bound, None),
            ("teacher_forced_backward", 457, tf_err["backward"], bwd_ms,
             bwd_plain_ms, bwd_bound, None),
            ("teacher_forced_weight_grads", 457, tf_err["helper"], helper_ms,
             helper_plain_ms, helper_bound, helper_library_ms)):
        kernels.append({
            "name": name, "route": "cuda", "source": tf_source,
            "replaces": "{}:{}".format(tf_replaces, line),
            "launches": launches_train[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms})
    # Each kernel's rows of the phase "kernels at wide shapes" (W1-W3, and
    # kernel 2's W4-W6 and its second block at W5).
    for entry in kernels:
        rows = [row for row in wide_rows if row["kernel"] == entry["name"]]
        if rows:
            entry["wide"] = rows
    print("near-ties: block decode {}, step decode {}".format(ties_block,
                                                              ties_step))
    print("total wall time: {:.2f} s".format(
        time.perf_counter() - total_start))
    print("kernels: {}".format(json.dumps(
        {k["name"]: k["launches"] for k in kernels})))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
