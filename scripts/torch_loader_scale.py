#!/usr/bin/env python3
"""Time the port's dataset backends on a dataset.txt of gSCAN's size.

    python3 scripts/torch_loader_scale.py [--examples 367933] [--dir DIR]

Writes ``DIR/dataset.txt`` (a temporary directory by default, removed at
the end): the fixture's ``data/bench_fixture`` examples (train, then dev)
repeated in a train split of ``--examples`` examples (367,933, the
compositional splits' train set) and the fixture's 4,096 dev examples as
the dev split, with the fixture's header fields. Then, each in a process
of its own, it loads the train and dev splits as ``train`` does (one parse
shared by both, ``read_dataset``) with the ``"engine"`` backend (json) and
the ``"native"`` backend (the C++ scanner; its library built before the
timing), and prints one JSON line per backend: seconds to parse and to
read each split, and the process's peak resident memory. The CPU's name
and count are printed first: these are host numbers. The port only; it
needs no GPU.
"""

import argparse
import json
import os
import platform
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "data" / "bench_fixture"


def cpu_name() -> str:
    """The CPU's model name as ``lscpu`` reports it, or, where it reports
    none, its vendor, family and model numbers."""
    try:
        result = subprocess.run(["lscpu"], capture_output=True, text=True,
                                timeout=60)
    except (OSError, subprocess.SubprocessError):
        return platform.machine() or "unknown"
    fields = dict(line.split(":", 1) for line in result.stdout.splitlines()
                  if ":" in line)
    fields = {k.strip(): v.strip() for k, v in fields.items()}
    name = fields.get("Model name", "unknown")
    if name != "unknown":
        return name
    return "{} family {} model {} ({})".format(
        fields.get("Vendor ID", "?"), fields.get("CPU family", "?"),
        fields.get("Model", "?"), platform.machine())


def write_dataset(path: Path, examples: int) -> int:
    """The scaled dataset.txt, written example by example; returns its
    bytes."""
    with open(FIXTURE / "dataset.txt") as f:
        fixture = json.load(f)
    pool = fixture["examples"]["train"] + fixture["examples"]["dev"]
    header = {k: v for k, v in fixture.items() if k != "examples"}
    with open(path, "w") as f:
        f.write(json.dumps(header)[:-1] + ', "examples": {"train": [')
        for i in range(examples):
            if i:
                f.write(", ")
            f.write(json.dumps(pool[i % len(pool)]))
        f.write('], "dev": ' + json.dumps(fixture["examples"]["dev"])
                + "}}")
    return path.stat().st_size


def load(path: str, backend: str) -> dict:
    """One backend's load of the train and dev splits, timed."""
    sys.path.insert(0, str(ROOT))
    from multimodal_seq2seq_gscan_tpu_torch.data import native_loader
    from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
        GroundedScanDataset)
    if backend == "native":
        native_loader.library()  # built (or found) before the timing
    directory = str(FIXTURE)
    start = time.perf_counter()
    train = GroundedScanDataset(path, directory, split="train",
                                backend=backend)
    parsed = time.perf_counter()
    train.read_dataset()
    train_read = time.perf_counter()
    dev = GroundedScanDataset(path, directory, split="dev",
                              dataset=train.dataset)
    dev.read_dataset()
    end = time.perf_counter()
    return {"backend": train.backend, "train_examples": train.num_examples,
            "dev_examples": dev.num_examples,
            "parse_s": parsed - start, "read_train_s": train_read - parsed,
            "dev_s": end - train_read, "total_s": end - start,
            "peak_rss_gib": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--examples", type=int, default=367933)
    parser.add_argument("--dir", type=str, default="")
    parser.add_argument("--backend", type=str, default="",
                        help=argparse.SUPPRESS)  # the child's mode
    args = parser.parse_args()
    if args.backend:
        print(json.dumps(load(os.path.join(args.dir, "dataset.txt"),
                              args.backend)))
        return 0
    print("host CPU: {} x{}".format(cpu_name(), os.cpu_count()))
    directory = Path(args.dir or tempfile.mkdtemp(prefix="gscan_scale_"))
    directory.mkdir(parents=True, exist_ok=True)
    try:
        start = time.perf_counter()
        size = write_dataset(directory / "dataset.txt", args.examples)
        print("dataset.txt: {} train + 4096 dev examples, {} bytes, "
              "written in {:.1f} s".format(args.examples, size,
                                           time.perf_counter() - start))
        for backend in ("engine", "native"):
            result = subprocess.run(
                [sys.executable, __file__, "--dir", str(directory),
                 "--backend", backend], capture_output=True, text=True)
            if result.returncode != 0:
                print(result.stdout + result.stderr, file=sys.stderr)
                return result.returncode
            print(result.stdout.strip().splitlines()[-1], flush=True)
    finally:
        if not args.dir:
            shutil.rmtree(directory, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
