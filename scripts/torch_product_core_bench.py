#!/usr/bin/env python3
"""Time the port's float32 product core against the 128 x 128 designs it
was chosen over, and against torch.matmul, on the card.

    python3 scripts/torch_product_core_bench.py [--size N]

Builds ``scripts/product_core_bench.cu`` with ``nvcc`` into
``build/product_core_bench/`` and times, with CUDA events, C = A^T B at
M = N = K = N (default 4096; A and B N(0, 1), k-major): a 128 x 128 tile
with an 8 x 8 block of outputs a thread whose 32-term stage sums are added
plainly, the same with Kahan compensation, the core of
``csrc/product_core.cuh`` (a 128 x 256 tile, 8 x 16 a thread), and
torch.matmul with TF32 off. Prints each one's milliseconds, TFLOP/s and
largest error against a float64 product, and the card's name, power limit
and SM clock. The compiler's register and spill counts are printed first.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NAMES = ("128 x 128 tile, 8 x 8 a thread, stage sums added",
         "128 x 128 tile, 8 x 8 a thread, stage sums added with Kahan",
         "the core: 128 x 256 tile, 8 x 16 a thread")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=4096)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_product_core_bench: needs a CUDA device",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from multimodal_seq2seq_gscan_tpu_torch.ops import _build
    out = ROOT / "build" / "product_core_bench"
    out.mkdir(parents=True, exist_ok=True)
    library = out / "product_core_bench.so"
    result = subprocess.run(
        [_build._nvcc()] + _build.COMPILE_FLAGS + [
            "-shared", "-o", str(library),
            str(ROOT / "scripts" / "product_core_bench.cu")],
        capture_output=True, text=True)
    for line in (result.stdout + result.stderr).splitlines():
        if "Used" in line or "spill" in line or "error" in line:
            print(line.strip())
    if result.returncode != 0:
        return result.returncode
    lib = ctypes.CDLL(str(library))
    lib.product_core_bench.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                                       + [ctypes.c_int] * 3
                                       + [ctypes.c_void_p])
    torch.backends.cuda.matmul.allow_tf32 = False
    n = args.size
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(n, n, device="cuda", generator=gen)
    b = torch.randn(n, n, device="cuda", generator=gen)
    c = torch.empty(n, n, device="cuda")
    exact = a.double().T @ b.double()
    flops = 2.0 * n ** 3

    def ms_of(fn, repeats=5):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / repeats

    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for variant, name in enumerate(NAMES):
        def run(variant=variant):
            code = lib.product_core_bench(variant, a.data_ptr(), b.data_ptr(),
                                          c.data_ptr(), n, n, n, stream)
            if code != 0:
                raise RuntimeError("variant {}: CUDA error {}".format(
                    variant, code))
        ms = ms_of(run)
        rows.append((name, ms, float((c.double() - exact).abs().max())))
    ms = ms_of(lambda: torch.matmul(a.T, b, out=c))
    rows.append(("torch.matmul", ms, float((c.double() - exact).abs().max())))
    for name, ms, err in rows:
        print("{}: {:.3f} ms, {:.1f} TFLOP/s, max |err| vs float64 "
              "{:.2e}".format(name, ms, flops / ms / 1e9, err))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
