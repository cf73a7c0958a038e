"""Build and load the port's CUDA kernels: one ``nvcc`` call, bound by ctypes.

All ``csrc/*.cu`` files are compiled for ``sm_90a`` by a single ``nvcc`` call
into one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds). The library lands in ``build/torch_kernels/`` at the
root of the checkout, named by a hash of the sources and flags, so a second
run reuses it. Nothing is built or loaded when a module is imported: the first
kernel launch calls :func:`library`.

Each C entry point takes device pointers, ints and the CUDA stream, and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero code.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream as c_void_p, every int as c_int.
SIGNATURES = {
    # pq, keys, mask (nullable), energy_w, ctx, weights, B, M, H, stream
    "gscan_additive_attention": [_P] * 6 + [_I] * 3 + [_P],
    # 7 state inputs, 12 weights, 8 outputs, B, Mt, Mv, H, V, K, eos, stream
    "gscan_decode_block": [_P] * 27 + [_I] * 7 + [_P],
}

_library: Optional[ctypes.CDLL] = None
library_path: Optional[Path] = None
build_seconds: Optional[float] = None  # 0.0 when an earlier build was reused
build_log: str = ""


def sources() -> List[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SOURCE_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in filter(None, [cuda_home, "/usr/local/cuda"]):
        candidate = Path(root) / "bin" / "nvcc"
        if candidate.is_file():
            return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    global build_seconds, build_log
    target = BUILD_DIR / "libgscan_torch_kernels_{}.so".format(_digest())
    if target.is_file():
        build_seconds = 0.0
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = target.with_name("{}.{}.partial".format(target.name, os.getpid()))
    command = ([_nvcc()] + NVCC_FLAGS + ["-o", str(partial)]
               + [str(path) for path in sources()])
    start = time.perf_counter()
    result = subprocess.run(command, capture_output=True, text=True)
    build_seconds = time.perf_counter() - start
    build_log = result.stdout + result.stderr
    if result.returncode != 0:
        raise RuntimeError("nvcc failed ({}):\n{}\n{}".format(
            result.returncode, " ".join(command), build_log))
    os.replace(partial, target)  # atomic: concurrent builders never see half
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _library, library_path
    if _library is None:
        library_path = build()
        lib = ctypes.CDLL(str(library_path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.gscan_error_string.argtypes = [ctypes.c_int]
        lib.gscan_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


def check(code: int, name: str):
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        message = library().gscan_error_string(code).decode()
        raise RuntimeError("{} failed: CUDA error {} ({})".format(
            name, code, message))
