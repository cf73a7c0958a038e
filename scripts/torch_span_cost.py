"""The cost of the port's spans and counters (``utils/profiling.py``) while
a torch profiler runs, on the card, at the benchmark's cells' sizes, and
which part of a span takes it.

    python3 scripts/torch_span_cost.py [--rounds 6] [--cells a,b]
        [--sides a,b] [--out <file.json>]

Set-up is the benchmark's (``benchmark/drivers/``): the baseline decode of
16,384 rows a batch and the baseline's graphed chunks of K = 50. Then, in
turns, 10 decode batches and 2 chunks on each side:

- ``none``: no profiler; ``forced``: no profiler, the spans forced on;
- ``off``: under a fresh ``torch.profiler.profile`` of the host and the
  card, the recorder patched off (``profiling.enabled`` reads False: no
  span, no counter, the untraced chunk graph);
- ``on``: profiled, the recorder as the program has it (timing events on
  its timed spans alone);
- profiled, the recorder's span replaced here by a variant that takes
  timing events on every span (``all_events``) or: ``no_rf``
  (no ``record_function``), ``no_events`` (no CUDA timing events; in the
  chunk, a marked graph without its markers), ``unsynced`` (no events on
  the spans that sync the host), ``pool`` (events taken in turn from a
  pool made and recorded once before), ``bare`` (neither
  ``record_function`` nor events: the bookkeeping alone), ``rf_no_launch``
  (no ``record_function`` on ``gscan.chunk.launch``);
- a side ending in ``_h`` also opens the harness's own span around each
  unit (a ``record_function`` named ``chunk`` or ``decode_batch``, as a
  ``--trace 1`` run does); ``on_h_gc`` is ``on_h`` with Python's garbage
  collector off during the turn;
- with ``--interleave R``, the sides instead take turns unit by unit
  inside ``--sessions`` profiler sessions of R rounds, each unit
  synchronised and inside the harness's span (profiled sides only).

Every variant is patched in this script; the program is not changed. A
side's first unit is untimed (the profiler's first launches; each marked
chunk variant captures a graph of its own there). Each unit's host time
is taken between the returns of consecutive units, so one host stall
moves one unit only; a profiled turn's timed units lie in a ``window``
span, and the trace gives the turn's device idle share by the benchmark's
rule (``benchmark/harness/trace.py::reduce``). Also the host cost of one
span around nothing, for each variant, with and without a profiler.
Prints one JSON line of medians; ``--out`` keeps every reading.
"""

import argparse
import contextlib
import gc
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from benchmark.harness.core import Bench, load_cell  # noqa: E402
from benchmark.harness.trace import Tracer, reduce  # noqa: E402
from multimodal_seq2seq_gscan_tpu_torch.train import resident  # noqa: E402
from multimodal_seq2seq_gscan_tpu_torch.utils import profiling  # noqa: E402

PROGRAM_ENABLED, PROGRAM_SPAN = profiling.enabled, profiling._Span
PROGRAM_KEY = resident.ChunkGraphs.key
SYNCED = ("gscan.decode.check_inputs", "gscan.decode.exit_check")
POOL = []  # (event, event) pairs, each recorded once before use


def variant(record_function, events: str):
    """The program's ``_Span`` with ``record_function`` on, off or on the
    names a predicate admits, and its events ``all``, ``none``,
    ``unsynced`` or from the ``pool``."""

    class Span:
        def __init__(self, recorder, name, timed=False):
            self.recorder, self.name = recorder, name

        def __enter__(self):
            recorder, pair = self.recorder, None
            cuda = torch.cuda.is_initialized()
            self.captured = cuda and torch.cuda.is_current_stream_capturing()
            self.markers = recorder._markers if self.captured else None
            wanted = events in ("all", "pool") or (
                events == "unsynced" and self.name not in SYNCED)
            if cuda and wanted and (self.markers is not None
                                    or not self.captured):
                if events == "pool" and not self.captured:
                    pair = POOL[next(recorder._ids) % len(POOL)]
                else:
                    pair = tuple(torch.cuda.Event(enable_timing=True,
                                                  external=self.captured)
                                 for _ in range(2))
            stack = recorder._stack()
            self.record = profiling.SpanRecord(
                self.name, next(recorder._ids), stack[-1] if stack else None,
                time.time_ns(), pair)
            self.function = None
            if record_function is True or (
                    callable(record_function) and record_function(self.name)):
                self.function = torch.profiler.record_function(self.name)
                self.function.__enter__()
            if pair is not None:
                pair[0].record()
            stack.append(self.record)
            return self.record

        def __exit__(self, *exc):
            record = self.record
            if record.events is not None:
                record.events[1].record()
            if self.function is not None:
                self.function.__exit__(*exc)
            record.end_ns = time.time_ns()
            self.recorder._stack().pop()
            if not self.captured:
                self.recorder.records.append(record)
            elif self.markers is not None:
                self.markers.append(record)
            return False

    return Span


# side: (profiled, recorder on, span class or None for the program's)
SIDES = {
    "none": (False, False, None),
    "forced": (False, True, None),
    "off": (True, False, None),
    "on": (True, True, None),
    "all_events": (True, True, variant(True, "all")),
    "no_rf": (True, True, variant(False, "all")),
    "no_events": (True, True, variant(True, "none")),
    "unsynced": (True, True, variant(True, "unsynced")),
    "pool": (True, True, variant(True, "pool")),
    "bare": (True, True, variant(False, "none")),
    "rf_no_launch": (True, True, variant(
        lambda name: name != "gscan.chunk.launch", "all")),
}
CELLS = (("baseline.decode_16k", "greedy_decode", 10,
          ("none", "forced", "off", "on", "all_events", "no_rf",
           "no_events", "unsynced", "pool", "bare")),
         ("baseline.train_k50", "train_resident", 2,
          ("none", "off", "off_h", "on", "on_h", "no_rf_h",
           "rf_no_launch_h", "on_h_gc")))
SIDE = ["on"]  # the side whose marked chunk graph is replayed


def base(side: str) -> str:
    """The recorder's side of ``side`` (without ``_h`` and ``_gc``)."""
    return side.replace("_gc", "").replace("_h", "")


def keyed(self, widths, batch, data):
    """The program's graph key, and a marked graph per side."""
    key = PROGRAM_KEY(self, widths, batch, data)
    return key + (SIDE[0],) if key[-1] else key


def session(cell: str, driver: str, seed: int):
    module = importlib.import_module("benchmark.drivers." + driver)
    return module.Session(Bench(ROOT, load_cell(cell), seed, "cuda"))


def patched(side: str):
    profiled, on, span = SIDES[base(side)]
    profiling.enabled = PROGRAM_ENABLED if profiled and on else (
        (lambda: True) if on else (lambda: False))
    profiling._Span = span or PROGRAM_SPAN
    SIDE[0] = side
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                   ) if profiled else None


def restore():
    profiling.enabled, profiling._Span = PROGRAM_ENABLED, PROGRAM_SPAN
    profiling.recorder.clear()


def turn(unit, units: int, side: str, harness_span: str):
    """Host ms of each of ``units`` units on ``side``, after one untimed,
    and the device's idle % over them (None unprofiled)."""
    context = patched(side)
    tracer = Tracer(side.endswith("_h") or "_h_" in side)
    if "_gc" in side:
        gc.disable()
    if context is not None:
        context.__enter__()
    window = (torch.profiler.record_function("window")
              if context is not None else contextlib.nullcontext())

    def one():
        with tracer.span(harness_span):
            unit(Tracer(False))

    try:
        one()
        torch.cuda.synchronize()
        with window:
            times, last = [], time.perf_counter()
            for _ in range(units):
                one()
                now = time.perf_counter()
                times.append(1e3 * (now - last))
                last = now
            torch.cuda.synchronize()
            times[-1] += 1e3 * (time.perf_counter() - last)
    finally:
        if context is not None:
            context.__exit__(None, None, None)
        gc.enable()
        restore()
    if context is None:
        return times, None
    trace = reduce(context.profiler.kineto_results.events())
    return times, 100.0 * (1 - trace.busy_s / trace.window_s)


def interleaved(unit, sides, rounds: int, sessions: int,
                harness_span: str):
    """Host ms of each unit by side, the sides taking turns unit by unit
    inside each of ``sessions`` profiler sessions of ``rounds`` rounds
    (after one untimed round), each unit synchronised: the sessions' own
    spread is then shared by every side. Profiled sides only."""
    tracer, times = Tracer(True), {side: [] for side in sides}
    for session_ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            for r in range(rounds + 1):
                shift = (session_ + r) % len(sides)
                for side in sides[shift:] + sides[:shift]:
                    patched(side)
                    try:
                        began = time.perf_counter()
                        with tracer.span(harness_span):
                            unit(Tracer(False))
                        torch.cuda.synchronize()
                        if r:
                            times[side].append(
                                1e3 * (time.perf_counter() - began))
                    finally:
                        profiling.enabled = PROGRAM_ENABLED
                        profiling._Span = PROGRAM_SPAN
        profiling.recorder.clear()
    return times


def span_us(side: str, n: int = 2000) -> float:
    """Host us of one span around nothing on ``side``."""
    context = patched(side)
    if context is not None:
        context.__enter__()
    try:
        torch.cuda.synchronize()
        began = time.perf_counter()
        for _ in range(n):
            with profiling.span("gscan.test"):
                pass
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - began) / n
    finally:
        if context is not None:
            context.__exit__(None, None, None)
        restore()


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--rounds", type=int, default=6)
    parser.add_argument("--seed", type=int, default=2**31 + 19)
    parser.add_argument("--cells", default="",
                        help="comma-separated cells (default: both)")
    parser.add_argument("--sides", default="",
                        help="comma-separated sides (default: each cell's)")
    parser.add_argument("--interleave", type=int, default=0,
                        help="rounds a session of units taking turns by "
                             "side (0: turns of whole sessions)")
    parser.add_argument("--sessions", type=int, default=3)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.cuda.init()
    for _ in range(2048):
        pair = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
        for event in pair:
            event.record()
        POOL.append(pair)
    torch.cuda.synchronize()
    resident.ChunkGraphs.key = keyed
    result = {"device": torch.cuda.get_device_name(0), "span_us": {
        side: span_us(side) for side in SIDES if side != "none"}}
    for cell, driver, units, sides in CELLS:
        if args.cells and cell not in args.cells.split(","):
            continue
        if args.sides:
            sides = tuple(args.sides.split(","))
        harness_span = "decode_batch" if "decode" in cell else "chunk"
        s = session(cell, driver, args.seed)
        if args.interleave:
            times = interleaved(s.unit, sides, args.interleave,
                                args.sessions, harness_span)
            del s
            torch.cuda.empty_cache()
            medians = {side: statistics.median(t)
                       for side, t in times.items()}
            result[cell] = {"ms_per_unit": times, "median_ms": medians,
                            "quartiles_ms": {
                                side: statistics.quantiles(t, n=4)
                                for side, t in times.items()}}
            continue
        times = {side: [] for side in sides}
        turns = {side: [] for side in sides}
        idle = {side: [] for side in sides}
        for r in range(args.rounds):
            order = sides if r % 2 == 0 else tuple(reversed(sides))
            shift = r // 2 % len(sides)
            for side in order[shift:] + order[:shift]:
                unit_ms, idle_pct = turn(s.unit, units, side, harness_span)
                times[side].extend(unit_ms)
                turns[side].append(sum(unit_ms))
                idle[side].append(idle_pct)
        del s
        torch.cuda.empty_cache()
        medians = {side: statistics.median(t) for side, t in times.items()}
        result[cell] = {
            "ms_per_unit": times, "turn_ms": turns, "idle_pct": idle,
            "median_ms": medians,
            "median_turn_ms": {side: statistics.median(t)
                               for side, t in turns.items()},
            "median_idle_pct": {side: statistics.median(v)
                                for side, v in idle.items()
                                if None not in v},
        }
    line = json.dumps(result)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(json.dumps({key: {k: v for k, v in value.items()
                            if k.startswith("median")}
                      if isinstance(value, dict) and "median_ms" in value
                      else value for key, value in result.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
