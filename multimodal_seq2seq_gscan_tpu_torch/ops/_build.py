"""Build and load the port's CUDA kernels with ``nvcc``, bound by ctypes.

Each ``csrc/*.cu`` file is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and one more call links the objects into one
shared library with a plain C interface (no PyTorch headers, so the build
takes about a minute, most of it the cluster kernels' variants). The
library lands in ``build/torch_kernels/`` at the
root of the checkout, named by a hash of the sources and flags, so a second
run reuses it. Nothing is built or loaded when a module is imported: the first
kernel launch calls :func:`library`.

Each C entry point takes device pointers, ints and the CUDA stream, and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero code.
"""

import ctypes
import functools
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
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream as c_void_p, every int as c_int.
SIGNATURES = {
    # pq, keys, mask (nullable), energy_w, ctx, weights, B, M, H, vec,
    # stream
    "gscan_additive_attention": [_P] * 6 + [_I] * 4 + [_P],
    # the same pointers, B, M, H, small_bf16 (queries, mask, energy_w
    # bf16), stream
    "gscan_additive_attention_bf16": [_P] * 6 + [_I] * 4 + [_P],
    # 7 state inputs, 12 weights, 8 outputs, scratch (nullable), B, Mt, Mv,
    # H, V, K, eos, plan, vec, stream
    "gscan_decode_block": [_P] * 28 + [_I] * 9 + [_P],
    # 7 inputs, 12 weights, 4 outputs, scratch (null for a cluster plan),
    # B, T, num_steps, Mt, Mv, H, E, V, plan, stream
    "gscan_teacher_forced_forward": [_P] * 24 + [_I] * 9 + [_P],
    # 9 inputs, 12 weights, 5 outputs, scratch, the same 9 ints, stream
    "gscan_teacher_forced_backward": [_P] * 27 + [_I] * 9 + [_P],
    # stash, h_res, dlogits, 12 outputs, scratch, its floats, N, H, E, V,
    # stream
    "gscan_teacher_forced_weight_grads": [_P] * 16 + [_I] * 5 + [_P],
    # x, lengths, the rows' order, each direction's w_ih, w_hh, b_ih, b_hh
    # (the backward's null when unidirectional), out, hidden (nullable),
    # scratch (nullable), packed weights, B, T, In, H, dirs, sum, rows,
    # unit_groups, passes, stream
    "gscan_encoder_lstm": [_P] * 15 + [_I] * 9 + [_P],
}

_library: Optional[ctypes.CDLL] = None
library_path: Optional[Path] = None
build_seconds: Optional[float] = None  # 0.0 when an earlier build was reused
build_log: str = ""


def sources() -> List[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
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
    stem = "{}.{}".format(target.name, os.getpid())
    nvcc = _nvcc()
    start = time.perf_counter()
    jobs = []
    for path in sources():
        obj = BUILD_DIR / "{}.{}.o".format(stem, path.stem)
        log = open(BUILD_DIR / "{}.{}.log".format(stem, path.stem), "w+")
        command = [nvcc] + COMPILE_FLAGS + ["-c", str(path), "-o", str(obj)]
        jobs.append((command, obj, log, subprocess.Popen(
            command, stdout=log, stderr=subprocess.STDOUT, text=True)))
    logs, failed, pending = [], [], list(jobs)
    while pending:  # every process ends here
        for job in [job for job in pending if job[3].poll() is not None]:
            pending.remove(job)
            command, _, log, process = job
            log.seek(0)
            logs.append("{}: compiled in {:.1f} s\n{}".format(
                command[-3], time.perf_counter() - start, log.read()))
            log.close()
            os.remove(log.name)
            if process.returncode != 0:
                failed.append("nvcc failed ({}):\n{}\n{}".format(
                    process.returncode, " ".join(command), logs[-1]))
        time.sleep(0.05)
    if failed:
        raise RuntimeError("\n".join(failed))
    partial = BUILD_DIR / "{}.partial".format(stem)
    command = ([nvcc] + ARCH_FLAGS + ["-shared", "-o", str(partial)]
               + [str(obj) for _, obj, _, _ in jobs])
    result = subprocess.run(command, capture_output=True, text=True)
    build_seconds = time.perf_counter() - start
    build_log = "".join(logs) + result.stdout + result.stderr
    for _, obj, _, _ in jobs:
        os.remove(obj)
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
        # H, V, M_t, M_v, the bytes available, the bytes needed (out)
        lib.gscan_decode_block_plan.argtypes = [_I] * 4 + [
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)]
        lib.gscan_decode_block_plan.restype = ctypes.c_int
        for name in ("gscan_decode_block_plan_rows",
                     "gscan_decode_block_plan_slot_floats",
                     "gscan_decode_block_plan_grid"):
            getattr(lib, name).argtypes = [_I]
            getattr(lib, name).restype = ctypes.c_int
        # plan, B, H, V
        lib.gscan_decode_block_scratch_floats.argtypes = [_I] * 4
        lib.gscan_decode_block_scratch_floats.restype = ctypes.c_longlong
        # kernel, H, E, V, Mt, Mv, the bytes available, the bytes needed (out)
        lib.gscan_teacher_forced_plan.argtypes = [_I] * 6 + [
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)]
        lib.gscan_teacher_forced_plan.restype = ctypes.c_int
        # kernel, plan, B, H, E, V, Mt, Mv
        lib.gscan_teacher_forced_scratch_floats.argtypes = [_I] * 8
        lib.gscan_teacher_forced_scratch_floats.restype = ctypes.c_longlong
        lib.gscan_teacher_forced_plan_name.argtypes = [_I] * 2
        lib.gscan_teacher_forced_plan_name.restype = ctypes.c_char_p
        # rows, In, H, unit_groups, scratch
        lib.gscan_encoder_lstm_shared_bytes.argtypes = [_I] * 5
        lib.gscan_encoder_lstm_shared_bytes.restype = ctypes.c_longlong
        # rows, In, H, unit_groups
        lib.gscan_encoder_lstm_scratch_floats.argtypes = [_I] * 4
        lib.gscan_encoder_lstm_scratch_floats.restype = ctypes.c_longlong
        lib.gscan_max_shared_memory_per_block.argtypes = [_I]
        lib.gscan_max_shared_memory_per_block.restype = ctypes.c_longlong
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


def device_index(device) -> int:
    """The index of a CUDA ``torch.device`` (the current device if unset)."""
    import torch
    return device.index if device.index is not None \
        else torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def shared_memory_per_block(index: int) -> int:
    """Bytes of shared memory a CTA may opt in to on CUDA device ``index``,
    as the device reports them."""
    return library().gscan_max_shared_memory_per_block(index)


def refuse_shared_memory(kernel: str, need: int, have: int):
    """Raise for a CUDA call whose shapes need more shared memory per CTA
    than the device has."""
    raise ValueError(
        "the {} kernel needs {} bytes of shared memory per CTA at these "
        "shapes, and the device has {}".format(kernel, need, have))
