"""One run of one cell: set-up, the measured window, the per-layer
readers, the check against the reference and the result line.

Everything a cell needs is found by name: the cell's entry in
``BENCHMARK.json``, its configuration file (the entry's ``file``), its
traffic mix ``benchmark/traffic/<traffic>.json``, whose ``driver`` names a
module of ``benchmark/drivers/``, its limits
``benchmark/limits/<cell>.json``, and each per-layer metric's reader
``benchmark/metrics/<metric>.py``. A cell is added by adding such files
and entries.

A driver module defines ``Session(bench)``, whose construction is the
cell's set-up (data, weights, every shape warmed), with ``unit(tracer)``
(one unit of the traffic, returning once the host holds its result, and
a record of what it ran), ``end_to_end(units, window_s)`` (each unit's
start and return, and the window's length up to the device's last
work),
``counts(records)`` for the per-layer readers and ``finish()`` (the
program's outputs that the check needs, the program's state freed); and
``numbers(bench, finished)``, which runs the reference and returns the
numbers compared (and ``readings(bench, finished)``, which adds the
control's and a planted fault's, for ``benchmark/tools/calibrate.py``).
"""

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import List, NamedTuple, Optional

from benchmark.harness import checks
from benchmark.harness.trace import Tracer

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "multimodal_seq2seq_gscan_tpu")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str) -> Cell:
    with open(ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise SystemExit("no workload {!r} in BENCHMARK.json (have {})".format(
            name, sorted(entries)))
    entry = entries[name]
    configs = {c["name"]: c for c in spec["configs"]}
    with open(ROOT / configs[entry["config"]]["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / (entry["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(BENCH_DIR / "limits" / (name + ".json")) as f:
        limits = json.load(f)
    end_to_end = [m for m in spec["end_to_end"]
                  if name in m.get("workloads", [name])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name, int(entry["chips"]), config, traffic, limits,
                end_to_end, per_layer)


class Bench(NamedTuple):
    """What a driver's set-up is given."""

    root: Path
    cell: Cell
    seed: int
    device: str


class Context(NamedTuple):
    """What a per-layer reader is given."""

    trace: object     # harness.trace.Trace of the traced window
    counts: dict      # the driver's counts over the traced units
    config: dict


def banned_modules() -> List[str]:
    return sorted(name for name in sys.modules
                  if name.split(".")[0] in BANNED)


def _reader(metric: str):
    path = BENCH_DIR / "metrics" / (metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _sync(device: str):
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str, start: float) -> Optional[dict]:
    """One run; the result line's object, or None when a banned module is
    loaded once the window has closed (named on standard error)."""
    import torch
    cell = load_cell(name)
    driver = importlib.import_module(
        "benchmark.drivers." + cell.traffic["driver"])
    bench = Bench(ROOT, cell, int(seed), device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    session = driver.Session(bench)
    _sync(device)
    gc.collect()
    tracer = Tracer(bool(trace))
    tracer.start()
    if trace:
        session.unit(tracer)  # the profiler's own first-launch costs
    _sync(device)
    window_start = time.perf_counter()
    setup_s = time.time() - start
    units, records = [], []
    limit_units = int(cell.traffic["trace_units"]) if trace else None
    with tracer.span("window"):
        while True:
            began = time.perf_counter()
            records.append(session.unit(tracer))
            units.append((began, time.perf_counter()))
            if limit_units is not None and len(units) >= limit_units:
                break
            if units[-1][1] - window_start >= seconds:
                break
        _sync(device)
    window_s = time.perf_counter() - window_start
    tracer.stop()
    memory_peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                   else 0)
    metrics, breakdown, device_info = {}, None, _device(device, cell.chips,
                                                         memory_peak)
    if trace:
        context = Context(tracer.trace, session.counts(records),
                          cell.config)
        for metric in cell.per_layer:
            value = _reader(metric["name"])(context)
            if value is not None:
                metrics[metric["name"]] = {"value": float(value),
                                           "unit": metric["unit"]}
        device_info["busy_s"] = tracer.trace.busy_s
        device_info["window_s"] = tracer.trace.window_s
        breakdown = {"device_ops": tracer.trace.top_ops(10),
                     "idle_gaps": [[name, seconds_]
                                   for seconds_, name in tracer.trace.gaps]}
    else:
        values = dict(session.end_to_end(units, window_s))
        values["setup_s"] = setup_s
        for metric in cell.end_to_end:
            metrics[metric["name"]] = {"value": float(values[metric["name"]]),
                                       "unit": metric["unit"]}
    finished = session.finish()
    del session
    results = checks.judged(driver.numbers(bench, finished), cell.limits)
    found = banned_modules()
    if found:
        print("banned modules loaded: {}".format(", ".join(found)),
              file=sys.stderr)
        return None
    correct = all(c.passed for c in results)
    result = {"correct": correct, "attempted": len(units),
              "failed": sum(1 for c in results if not c.passed),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in results}
    return result


def _device(device: str, chips: int, memory_peak: int) -> dict:
    import torch
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(memory_peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}
