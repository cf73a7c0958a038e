#!/usr/bin/env python3
"""Where kernel 4's time goes, phase by phase, on the card.

    python3 scripts/torch_kernel4_phases.py [--repeats R]

Builds a timed copy of the port's kernels in ``build/variants/phase-timing``
(``scripts/kernel4_phase_timing.patch`` applied to
``csrc/teacher_forced.cu``), in which thread 0 of the first CTA of
``backward_cluster_kernel`` reads the card's global timer after each phase
of every step and adds the difference to a per-phase counter. Runs kernel 4
at the training main path's shapes (B=200, T=56, num_steps=53, M_t=16,
M_v=36, H=E=100, V=9; ``chip_smoke.py``'s random inputs, seed 0) and prints
each phase's microseconds per step. A phase ends at a barrier, so it
includes the wait for the slowest CTA of the cluster. The timed build is
for this breakdown only: the kernel's time beside it is that build's. When
the kernel changes, the patch is brought up to date with it.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PATCH = Path(__file__).resolve().parent / "kernel4_phase_timing.patch"
PHASES = [
    "step inputs (embedding, wait for prefetch)", "textual query",
    "textual attention", "visual query", "visual projected query",
    "visual attention", "cell, new h to every CTA", "d_pre partials",
    "d_lstm_in partials",
    "d_lstm_in reduce, visual context cotangent",
    "visual attention backward", "d visual query partials",
    "d_joint partials", "textual context cotangent",
    "textual attention backward", "dh partials", "dh reduce, stash",
    "gate product", "head product", "d_ph", "d_pre reduce",
    "cell backward", "wait before the d_lstm_in partials"]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel4_phases: needs a CUDA device", file=sys.stderr)
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
    counters = (ctypes.c_ulonglong * 32)()
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    steps, num_steps = 56, 53
    with torch.no_grad(), full_float32():
        inputs, (dlogits, g_asum) = cs.random_teacher_forced_inputs(
            gen, device, 200, steps, num_steps, 16, 36, 100, 9, 1)
        _, h_res, c_res, _ = tf.teacher_forced_forward(
            *inputs, num_steps=num_steps)

        def backward():
            tf.teacher_forced_backward(
                *inputs[:3], *inputs[5:], h_res, c_res, dlogits, g_asum,
                num_steps=num_steps)

        backward()
        torch.cuda.synchronize()
        _build.check(lib.gscan_phase_ns_read(counters, 1), "phase read")
        ms = cs.cuda_ms(backward, args.repeats, warmup=0)
        _build.check(lib.gscan_phase_ns_read(counters, 1), "phase read")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    per_step = [counters[i] / args.repeats / steps / 1e3
                for i in range(len(PHASES))]
    print("{}; kernel 4 (timed build): {:.4f} ms per launch; phases of "
          "CTA 0 sum to {:.4f} ms".format(smi, ms,
                                          sum(per_step) * steps / 1e3))
    for name, us in sorted(zip(PHASES, per_step), key=lambda p: -p[1]):
        print("  {:8.2f} us/step  {}".format(us, name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
