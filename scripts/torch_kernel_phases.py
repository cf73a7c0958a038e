#!/usr/bin/env python3
"""Where the time of kernels 3 and 4, or of kernel 2, goes, phase by phase,
on the card.

    python3 scripts/torch_kernel_phases.py [--repeats R]
                                           [--kernel 2|grid|tf-grid]

With ``--kernel 2``: builds a copy with ``kPhaseTiming = 1`` in
``csrc/decode_block.cu`` (``build/variants/decode-phase-timing``), in which
thread 0 of every CTA of kernel 2 adds each phase's clock cycles to a
counter (a phase ends at a barrier), and runs kernel 2 on the fixture's two
decode blocks (``chip_smoke.fixture_blocks``) and on one 32-step block from
SOS on random inputs, printing each phase's cycles per CTA-step and share.

With ``--kernel grid``: a copy with ``kGridPhaseTiming = 1`` in
``csrc/decode_grid.cu`` (``build/variants/decode-grid-phase-timing``), in
which thread 0 of CTA 0 of kernel
2's grid plan (``csrc/decode_grid.cu``) adds each phase's clock cycles
(barrier to barrier, so the slowest CTA's) and its waits in the grid
barriers to counters; runs one 32-step launch from SOS at B = 1024, M_t =
16, M_v = 36, V = 9 and H = E = 449, 640, 1024, every row emitting every
step (EOS outside the vocabulary), and at H = E = 640 with 90% of the rows
done at entry (EOS 2), printing each phase's milliseconds per launch.

With ``--kernel tf-grid``: a copy with ``kTfGridPhaseTiming = 1`` in
``csrc/teacher_forced_grid.cu`` (``build/variants/tf-grid-phase-timing``):
kernels 3 and 4's grid plans, each phase's milliseconds per launch (barrier
to barrier, CTA 0's clock) at W3, W4, H = 512 and W6, B = 200, T = 56 (W2
takes the L2 cluster plans).

Without any:

Builds a timed copy of the port's kernels in ``build/variants/phase-timing``
(``scripts/kernel_phase_timing.patch`` applied to
``csrc/teacher_forced.cu``), in which thread 0 of the first CTA of
``forward_cluster_kernel`` (kernel 3) and of ``backward_cluster_kernel``
(kernel 4) reads the card's global timer after each phase of every step and
adds the difference to a per-phase counter. Runs each kernel at the training
main path's shapes (B=200, T=56, num_steps=53, M_t=16, M_v=36, H=E=100, V=9;
``chip_smoke.py``'s random inputs, seed 0) and prints each phase's
microseconds per step. A phase ends at a barrier, so it includes the wait
for the slowest CTA of the cluster. The timed build is for this breakdown
only: each kernel's time beside it is that build's. When the kernels change,
the patch is brought up to date with them.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PATCH = Path(__file__).resolve().parent / "kernel_phase_timing.patch"
# Counter index -> phase, kernel 4's from 0 and kernel 3's from 32 (the
# phases of the step forward, which both run, have the same number in both).
STEP_FORWARD = {1: "textual query", 2: "textual attention",
                3: "visual query", 4: "visual projected query",
                5: "visual attention", 17: "gate product",
                6: "cell, new h to every CTA", 18: "head product"}
KERNEL4 = {**STEP_FORWARD, **{
    0: "step inputs (embedding, wait for prefetch)", 19: "d_ph",
    7: "d_pre partials", 20: "d_pre reduce", 21: "cell backward",
    22: "wait before the d_lstm_in partials", 8: "d_lstm_in partials",
    9: "d_lstm_in reduce, visual context cotangent",
    10: "visual attention backward", 11: "d visual query partials",
    12: "d_joint partials", 13: "textual context cotangent",
    14: "textual attention backward", 15: "dh partials",
    16: "dh reduce, stash"}}
KERNEL3 = {**STEP_FORWARD, **{
    0: "step inputs (embedding x dropout, residuals)",
    7: "logits of the step before (partial sums in rank order)",
    8: "summed attention, logits' partial sums to the owners"}}


DECODE_BLOCK = ("embedding, textual query", "textual attention",
                "visual query, projected visual query", "visual attention",
                "gate product and cell", "head product, carried h",
                "logits", "argmax, retiring rows, compaction")


def decode_block_phases(repeats):
    """Kernel 2's phases (kPhaseTiming) on the fixture's blocks and on a
    random block from SOS."""
    import torch
    from torch_kernel_ab import fixture, load_chip_smoke, variant_checkout
    sys.path.insert(0, str(variant_checkout(ROOT, "decode-phase-timing",
                                            ["kPhaseTiming=1"])))
    cs = load_chip_smoke()
    from multimodal_seq2seq_gscan_tpu_torch.ops import _build
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    from multimodal_seq2seq_gscan_tpu_torch.utils.precision import (
        full_float32)
    lib = _build.library()
    lib.gscan_decode_block_phase_cycles.argtypes = [ctypes.c_void_p]
    counters = (ctypes.c_ulonglong * (len(DECODE_BLOCK) + 4))()
    device = torch.device("cuda")
    state, config, dev_batch, _ = fixture(cs)
    eos = config.target_eos_idx
    with torch.no_grad(), full_float32():
        gen = torch.Generator(device=device).manual_seed(0)
        cases = [("fixture block {}".format(i + 1), args) for i, args in
                 enumerate(cs.fixture_blocks(state.params, config,
                                             dev_batch))]
        cases.append(("random block from SOS", cs.random_block_inputs(
            gen, device, cs.BATCH, 16, 36, 100, 9, 1)))
        for label, args in cases:
            def run():
                k2.fused_decode_block(*args, num_steps=cs.EXIT_CHECK_EVERY,
                                      eos_idx=eos)
            run()
            torch.cuda.synchronize()
            _build.check(lib.gscan_decode_block_phase_cycles(counters),
                         "phase read")
            ms = cs.cuda_ms(run, repeats, warmup=0)
            _build.check(lib.gscan_decode_block_phase_cycles(counters),
                         "phase read")
            cta_steps = counters[len(DECODE_BLOCK)]
            total = sum(counters[:len(DECODE_BLOCK)])
            print("{}; kernel 2, {} (timed build): {:.4f} ms per launch, "
                  "{:.1f} CTA-steps per launch, {:.0f} cycles per "
                  "CTA-step".format(cs.nvidia_smi_line(), label, ms,
                                    cta_steps / repeats,
                                    total / max(cta_steps, 1)))
            for i, name in enumerate(DECODE_BLOCK):
                print("  {:10.0f} cycles/CTA-step {:5.1f}%  {}".format(
                    counters[i] / max(cta_steps, 1),
                    100 * counters[i] / max(total, 1), name))
            n = len(DECODE_BLOCK)
            print("  of the products: {:.0f} cycles/CTA-step waiting for "
                  "weight tiles, {:.0f} in the ring's barriers, {:.0f} "
                  "issuing copies".format(
                      *(counters[n + i] / max(cta_steps, 1)
                        for i in (1, 2, 3))))
    return 0


DECODE_GRID = ("entry: rows to slots, the folded head", "textual query",
               "textual attention", "visual query", "visual query tanh",
               "visual projection", "visual attention", "gate product",
               "cell", "logits product", "argmax",
               "compaction, retiring rows")


def decode_grid_phases(repeats):
    """The grid plan's phases (kGridPhaseTiming) at W4-W6 and W5 90%
    done."""
    import torch
    from torch_kernel_ab import load_chip_smoke, variant_checkout
    sys.path.insert(0, str(variant_checkout(ROOT, "decode-grid-phase-timing",
                                            ["kGridPhaseTiming=1"])))
    cs = load_chip_smoke()
    from multimodal_seq2seq_gscan_tpu_torch.ops import _build
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    from multimodal_seq2seq_gscan_tpu_torch.utils.precision import (
        full_float32)
    lib = _build.library()
    lib.gscan_decode_grid_phase_cycles.argtypes = [ctypes.c_void_p]
    counters = (ctypes.c_ulonglong * (len(DECODE_GRID) + 2))()
    device = torch.device("cuda")
    clock_hz = torch.cuda.get_device_properties(device).clock_rate * 1e3
    with torch.no_grad(), full_float32():
        gen = torch.Generator(device=device).manual_seed(0)
        # EOS 9 lies outside the vocabulary: every row emits every step.
        for name, h, done, eos in (("W4", 449, 0.0, 9), ("W5", 640, 0.0, 9),
                                   ("W6", 1024, 0.0, 9),
                                   ("W5 90% done", 640, 0.9, 2)):
            args = cs.random_block_inputs(gen, device, 1024, 16, 36, h, 9, 1,
                                          done_fraction=done)

            def run():
                k2.fused_decode_block(*args, num_steps=cs.EXIT_CHECK_EVERY,
                                      eos_idx=eos)
            run()
            torch.cuda.synchronize()
            _build.check(lib.gscan_decode_grid_phase_cycles(counters),
                         "phase read")
            ms = cs.cuda_ms(run, repeats, warmup=0)
            _build.check(lib.gscan_decode_grid_phase_cycles(counters),
                         "phase read")
            n = len(DECODE_GRID)
            total = sum(counters[:n])
            print("{}; kernel 2's grid plan, {} (H={}; timed build): {:.4f} "
                  "ms per launch, {:.1f} steps per launch, {:.4f} ms by CTA "
                  "0's clock at {:.0f} MHz, of them {:.4f} ms in grid "
                  "barriers".format(
                      cs.nvidia_smi_line(), name, h, ms,
                      counters[n + 1] / repeats,
                      total / repeats / clock_hz * 1e3, clock_hz / 1e6,
                      counters[n] / repeats / clock_hz * 1e3))
            for i, phase in enumerate(DECODE_GRID):
                print("  {:9.4f} ms {:5.1f}%  {}".format(
                    counters[i] / repeats / clock_hz * 1e3,
                    100 * counters[i] / max(total, 1), phase))
            del args
    return 0


TF_GRID = {
    3: ("entry: h0, c0 to the scratch",
        "textual query; the embedding, residuals, last step's logits",
        "textual attention", "visual query", "visual query tanh",
        "visual projection", "visual attention",
        "gate product; the summed attention", "cell", "head product",
        "head sums", "logits product"),
    4: ("entry: the transposed weights, the last step's inputs",
        "textual query; d_ph product", "textual attention; d_ph sums",
        "visual query; d_pre product", "visual query tanh; d_pre sums",
        "visual projection", "visual attention", "gate product",
        "cell forward and backward", "head product; d_lstm product",
        "head and d_lstm sums; visual attention backward",
        "d visual query product; the next step's inputs",
        "d_joint_pre; the stash", "d_joint product; the next embedding",
        "textual attention backward; dh_joint", "dh_txt product",
        "dh")}
TF_GRID_SHAPES = (("W3", 256, 72, 144), ("W4", 449, 16, 36),
                  ("H512", 512, 16, 36), ("W6", 1024, 16, 36))


def teacher_forced_grid_phases(repeats):
    """Kernels 3 and 4's grid plans phase by phase (kTfGridPhaseTiming) at
    W3, W4, H = 512 and W6, B = 200, T = 56."""
    import torch
    from torch_kernel_ab import load_chip_smoke, variant_checkout
    sys.path.insert(0, str(variant_checkout(ROOT, "tf-grid-phase-timing",
                                            ["kTfGridPhaseTiming=1"])))
    cs = load_chip_smoke()
    from multimodal_seq2seq_gscan_tpu_torch.ops import _build
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    from multimodal_seq2seq_gscan_tpu_torch.utils.precision import (
        full_float32)
    lib = _build.library()
    lib.gscan_teacher_forced_grid_phase_cycles.argtypes = [ctypes.c_int,
                                                           ctypes.c_void_p]
    width = max(len(names) for names in TF_GRID.values()) + 2
    counters = (ctypes.c_ulonglong * width)()
    device = torch.device("cuda")
    clock_hz = torch.cuda.get_device_properties(device).clock_rate * 1e3
    steps, num_steps = cs.TRAIN_T, cs.TRAIN_T - 3
    with torch.no_grad(), full_float32():
        gen = torch.Generator(device=device).manual_seed(0)
        for name, h, m_t, m_v in TF_GRID_SHAPES:
            inputs, (dlogits, g_asum) = cs.random_teacher_forced_inputs(
                gen, device, cs.TRAIN_BATCH, steps, num_steps, m_t, m_v, h,
                9, 1)
            _, h_res, c_res, _ = tf.teacher_forced_forward(
                *inputs, num_steps=num_steps)
            runs = {3: lambda: tf.teacher_forced_forward(
                        *inputs, num_steps=num_steps),
                    4: lambda: tf.teacher_forced_backward(
                        *inputs[:3], *inputs[5:], h_res, c_res, dlogits,
                        g_asum, num_steps=num_steps)}
            for kernel, run in runs.items():
                names = TF_GRID[kernel]
                run()
                torch.cuda.synchronize()
                _build.check(lib.gscan_teacher_forced_grid_phase_cycles(
                    kernel, counters), "phase read")
                ms = cs.cuda_ms(run, repeats, warmup=0)
                _build.check(lib.gscan_teacher_forced_grid_phase_cycles(
                    kernel, counters), "phase read")
                n = width - 2
                total = sum(counters[:n])
                print("{}; kernel {}'s grid plan, {} (H={}, M_t={}, M_v={}, "
                      "B={}, T={}; timed build): {:.4f} ms per launch, "
                      "{:.1f} steps per launch, {:.4f} ms by CTA 0's clock "
                      "at {:.0f} MHz, of them {:.4f} ms in grid "
                      "barriers".format(
                          cs.nvidia_smi_line(), kernel, name, h, m_t, m_v,
                          cs.TRAIN_BATCH, steps, ms,
                          counters[n + 1] / repeats,
                          total / repeats / clock_hz * 1e3, clock_hz / 1e6,
                          counters[n] / repeats / clock_hz * 1e3))
                for i, phase in enumerate(names):
                    print("  {:9.4f} ms {:5.1f}%  {}".format(
                        counters[i] / repeats / clock_hz * 1e3,
                        100 * counters[i] / max(total, 1), phase))
            del inputs, dlogits, g_asum, h_res, c_res
    return 0


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--kernel", choices=("2", "grid", "3", "tf-grid"),
                        default="3",
                        help="2: kernel 2; grid: kernel 2's grid plan; 3 "
                        "(default): kernels 3 and 4; tf-grid: their grid "
                        "plans")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_phases: needs a CUDA device", file=sys.stderr)
        return 1
    if args.kernel == "2":
        return decode_block_phases(args.repeats)
    if args.kernel == "grid":
        return decode_grid_phases(args.repeats)
    if args.kernel == "tf-grid":
        return teacher_forced_grid_phases(args.repeats)
    from torch_kernel_ab import load_chip_smoke, variant_checkout
    sys.path.insert(0, str(variant_checkout(ROOT, "phase-timing",
                                            patch=PATCH)))
    cs = load_chip_smoke()
    from multimodal_seq2seq_gscan_tpu_torch.ops import _build
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    from multimodal_seq2seq_gscan_tpu_torch.utils.precision import (
        full_float32)
    lib = _build.library()
    lib.gscan_phase_ns_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    counters = (ctypes.c_ulonglong * 64)()
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    steps, num_steps = 56, 53
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with torch.no_grad(), full_float32():
        inputs, (dlogits, g_asum) = cs.random_teacher_forced_inputs(
            gen, device, 200, steps, num_steps, 16, 36, 100, 9, 1)
        _, h_res, c_res, _ = tf.teacher_forced_forward(
            *inputs, num_steps=num_steps)

        def forward():
            tf.teacher_forced_forward(*inputs, num_steps=num_steps)

        def backward():
            tf.teacher_forced_backward(
                *inputs[:3], *inputs[5:], h_res, c_res, dlogits, g_asum,
                num_steps=num_steps)

        for label, run, phases, base in (("kernel 3", forward, KERNEL3, 32),
                                         ("kernel 4", backward, KERNEL4, 0)):
            run()
            torch.cuda.synchronize()
            _build.check(lib.gscan_phase_ns_read(counters, 1), "phase read")
            ms = cs.cuda_ms(run, args.repeats, warmup=0)
            _build.check(lib.gscan_phase_ns_read(counters, 1), "phase read")
            per_step = {name: counters[base + i] / args.repeats / steps / 1e3
                        for i, name in phases.items()}
            print("{}; {} (timed build): {:.4f} ms per launch; phases of "
                  "CTA 0 sum to {:.4f} ms".format(
                      smi, label, ms, sum(per_step.values()) * steps / 1e3))
            for name, us in sorted(per_step.items(), key=lambda p: -p[1]):
                print("  {:8.2f} us/step  {}".format(us, name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
