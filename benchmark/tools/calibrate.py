"""Readings that a cell's limits are set from: the program's numbers over
many seeds, and over a few of them the control's (the reference in TF32)
and a planted fault's, each at the cell's own size, in one process.

    python3 benchmark/tools/calibrate.py --workload <name> \
        --seeds <a,b,...> --control-seeds <a,b,...> [--out <file.json>]

A decode cell runs a short window of ``checked_batches`` batches a seed;
a training cell needs none (its numbers come from set-up's first 1 + K
steps, the last K on the window's own graph).
Runs on the card (``--device cpu`` rehearses it with the plain versions).
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.harness.core import ROOT, Bench, load_cell  # noqa: E402
from benchmark.harness.trace import Tracer  # noqa: E402


def readings(name, seed, device, with_control):
    cell = load_cell(name)
    driver = importlib.import_module("benchmark.drivers."
                                     + cell.traffic["driver"])
    bench = Bench(ROOT, cell, seed, device)
    start = time.perf_counter()
    session = driver.Session(bench)
    for _ in range(int(cell.traffic.get("checked_batches", 0))):
        session.unit(Tracer(False))
    finished = session.finish()
    del session
    out = {"seed": seed, "setup_and_window_s": time.perf_counter() - start}
    start = time.perf_counter()
    if with_control:
        out.update(driver.readings(bench, finished))
    else:
        out["program"] = driver.numbers(bench, finished)
    out["reference_s"] = time.perf_counter() - start
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default="")
    args = parser.parse_args()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in seeds:
        row = readings(args.workload, seed, args.device, seed in controls)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    for kind in ("program", "control", "fault"):
        values = [r[kind] for r in rows if kind in r]
        if values:
            print(kind, {name: (min(v[name] for v in values),
                                max(v[name] for v in values))
                         for name in values[0]})


if __name__ == "__main__":
    main()
