#!/usr/bin/env python3
"""Where the time of kernels 3 and 4 goes, phase by phase, on the card.

    python3 scripts/torch_kernel_phases.py [--repeats R]

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


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_phases: needs a CUDA device", file=sys.stderr)
        return 1
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
