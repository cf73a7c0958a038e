"""ctypes binding of the port's C++ dataset scanner (``native/gscan_loader.cc``).

The scanner memory-maps dataset.txt, records each example's string spans
and rasterizes its dense situation grid in one pass. Strings (commands,
derivations, the situation's JSON) are decoded lazily from the mapped file.

The library is built at first use with the host's C++ compiler
(``g++ -O3 -march=native -shared -fPIC -std=c++17``) into
``build/torch_native/`` at the root of the checkout, named by a hash of the
source, the flags and what ``-march=native`` means to the compiler on this
host: a library is loaded only where it was built for, and a second run
reuses it. Nothing is built when the module is imported. ``library()``
raises ``RuntimeError`` when the library cannot be built;
``data/dataset.py`` decides what its backends do about that.
"""

import ctypes
import hashlib
import json
import mmap
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "native" / "gscan_loader.cc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_native"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_library: Optional[ctypes.CDLL] = None


def compiler() -> str:
    """The host's C++ compiler: g++, else c++, on the PATH."""
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("the native loader needs a C++ compiler (g++ or c++ "
                       "on the PATH)")


def _digest(cxx: str) -> str:
    h = hashlib.sha256(" ".join([os.path.basename(cxx)] + FLAGS).encode())
    h.update(SOURCE.read_bytes())
    # What -march=native resolves to here: a library built on another CPU
    # gets another name.
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, timeout=120)
    h.update((target.stdout + target.stderr).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the scanner unless a library of the same source, flags and
    host exists; returns its path."""
    cxx = compiler()
    target = BUILD_DIR / "libgscan_loader_{}.so".format(_digest(cxx))
    if target.is_file():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = BUILD_DIR / "{}.{}.partial".format(target.name, os.getpid())
    command = [cxx] + FLAGS + [str(SOURCE), "-o", str(partial)]
    result = subprocess.run(command, capture_output=True, text=True,
                            timeout=600)
    if result.returncode != 0:
        raise RuntimeError("building the native loader failed ({}):\n{}\n"
                           "{}".format(result.returncode, " ".join(command),
                                       result.stdout + result.stderr))
    os.replace(partial, target)  # atomic: concurrent builders never see half
    return target


def library() -> ctypes.CDLL:
    """The loaded scanner, built at first use."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        lib.gscan_open.restype = ctypes.c_void_p
        lib.gscan_open.argtypes = [ctypes.c_char_p]
        lib.gscan_error.restype = ctypes.c_char_p
        lib.gscan_error.argtypes = [ctypes.c_void_p]
        lib.gscan_grid_size.restype = ctypes.c_int
        lib.gscan_grid_size.argtypes = [ctypes.c_void_p]
        lib.gscan_channels.restype = ctypes.c_int
        lib.gscan_channels.argtypes = [ctypes.c_void_p]
        lib.gscan_split_size.restype = ctypes.c_int64
        lib.gscan_split_size.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.gscan_list_splits.restype = ctypes.c_int
        lib.gscan_list_splits.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_int]
        lib.gscan_fill_split.restype = ctypes.c_int
        lib.gscan_fill_split.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8)]
        lib.gscan_close.argtypes = [ctypes.c_void_p]
        _library = lib
    return _library


class NativeSplit:
    """One split's examples: lazy strings, and the grids and positions the
    scanner filled. A slice is a split of the sliced examples."""

    def __init__(self, data, offsets: np.ndarray, positions: np.ndarray,
                 grids: np.ndarray):
        self._data = data
        self.offsets = offsets      # [n, 8] int64: (offset, length) x 4
        self.positions = positions  # [n, 2] int32: agent, target (r * g + c)
        self.grids = grids          # [n, g, g, c] uint8

    def __len__(self) -> int:
        return self.offsets.shape[0]

    def __getitem__(self, index: slice) -> "NativeSplit":
        if not isinstance(index, slice):
            raise TypeError("a NativeSplit takes slices; read an example "
                            "with command(i), situation(i), ...")
        return NativeSplit(self._data, self.offsets[index],
                           self.positions[index], self.grids[index])

    def _span(self, i: int, field: int) -> str:
        off = int(self.offsets[i, field * 2])
        length = int(self.offsets[i, field * 2 + 1])
        return self._data[off:off + length].decode("utf-8")

    def command(self, i: int) -> str:
        return self._span(i, 0)

    def derivation(self, i: int) -> str:
        return self._span(i, 1)

    def target_commands(self, i: int) -> str:
        return self._span(i, 2)

    def situation(self, i: int) -> dict:
        """The raw situation object, json-decoded on access."""
        return json.loads(self._span(i, 3))


class NativeDataset:
    """All splits of a dataset.txt, read by the scanner. Raises
    ``ValueError`` on a file it cannot parse."""

    def __init__(self, path: str):
        lib = library()
        handle = lib.gscan_open(path.encode())
        try:
            error = lib.gscan_error(handle)
            if error:
                raise ValueError("native loader failed: {}".format(
                    error.decode()))
            self.grid_size = lib.gscan_grid_size(handle)
            self.channels = lib.gscan_channels(handle)
            buffer = ctypes.create_string_buffer(4096)
            if lib.gscan_list_splits(handle, buffer, 4096) < 0:
                raise ValueError("native loader failed: the split names of "
                                 "{} exceed 4096 bytes".format(path))
            split_names = [s for s in buffer.value.decode().split(",") if s]
            with open(path, "rb") as f:
                raw = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            self.splits: Dict[str, NativeSplit] = {}
            for split in split_names:
                n = lib.gscan_split_size(handle, split.encode())
                offsets = np.zeros((n, 8), dtype=np.int64)
                positions = np.zeros((n, 2), dtype=np.int32)
                grids = np.zeros(
                    (n, self.grid_size, self.grid_size, self.channels),
                    dtype=np.uint8)
                if n > 0 and lib.gscan_fill_split(
                        handle, split.encode(),
                        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                        positions.ctypes.data_as(
                            ctypes.POINTER(ctypes.c_int32)),
                        grids.ctypes.data_as(
                            ctypes.POINTER(ctypes.c_uint8))) != 0:
                    raise ValueError("native loader failed: split {} could "
                                     "not be filled".format(split))
                self.splits[split] = NativeSplit(raw, offsets, positions,
                                                 grids)
        finally:
            lib.gscan_close(handle)

    def move_k_examples_to_train_and_dev(self, k: int, rng,
                                         split: str = "adverb_1"):
        """k random examples of ``split`` (``rng.sample``) appended to train
        and dev, and removed from ``split`` (the reference's k-shot move,
        dataset.py:499-514); a no-op without ``split`` or a train split."""
        if k <= 0 or split not in self.splits or "train" not in self.splits:
            return
        source = self.splits[split]
        n = len(source)
        chosen = rng.sample(range(n), k=min(k, n))
        chosen_set = set(chosen)
        keep = [i for i in range(n) if i not in chosen_set]
        for destination in ("train", "dev"):
            if destination not in self.splits:
                continue
            dest = self.splits[destination]
            self.splits[destination] = NativeSplit(
                dest._data,
                np.concatenate([dest.offsets, source.offsets[chosen]]),
                np.concatenate([dest.positions, source.positions[chosen]]),
                np.concatenate([dest.grids, source.grids[chosen]]))
        self.splits[split] = NativeSplit(
            source._data, source.offsets[keep], source.positions[keep],
            source.grids[keep])
