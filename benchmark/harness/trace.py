"""Spans around the benchmark's calls into the program, and the device
trace of a ``--trace 1`` window.

Spans are ``torch.profiler.record_function`` ranges opened by the
benchmark's own files (``window``, ``chunk``, ``decode_batch``,
``checksum``, ``read_result``); with tracing off they cost nothing. The
trace is torch.profiler's (CUPTI on the card). From it: every device
operation in the window, the union of their intervals (the busy time;
overlapping kernels are counted once), the idle gaps between them, each
named by the innermost span open on the host when it began, the device
time by kernel name, and the kernels that the harness itself launched
(host launch calls inside a ``checksum`` span).
"""

import contextlib
from typing import Dict, List, NamedTuple, Optional, Sequence

SPANS = ("chunk", "decode_batch", "checksum", "read_result")
HARNESS_SPAN = "checksum"  # the harness's own device work inside a unit


class DeviceOp(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Trace(NamedTuple):
    ops: List[DeviceOp]               # device operations inside the window
    window_s: float
    busy_s: float
    gaps: List[tuple]                 # the 10 longest: (seconds, span name)
    harness_launches: int             # kernels launched in HARNESS_SPAN

    def kernels(self) -> List[DeviceOp]:
        return [op for op in self.ops if not _is_copy(op.name)]

    def seconds(self, patterns: Sequence[str]) -> float:
        """Device seconds of the kernels whose name holds a pattern."""
        return sum(op.end_ns - op.start_ns for op in self.kernels()
                   if any(p in op.name for p in patterns)) / 1e9

    def count(self, patterns: Sequence[str]) -> int:
        return sum(1 for op in self.kernels()
                   if any(p in op.name for p in patterns))

    def top_ops(self, n: int = 10) -> List[list]:
        totals: Dict[str, int] = {}
        for op in self.ops:
            totals[op.name] = totals.get(op.name, 0) + op.end_ns - op.start_ns
        ranked = sorted(totals.items(), key=lambda item: -item[1])[:n]
        return [[_short(name), ns / 1e9] for name, ns in ranked]


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


class Tracer:
    """``span(name)`` ranges; with ``enabled``, a profile between
    ``start()`` and ``stop()`` that ``stop`` reduces to a ``Trace``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.profile = None
        self.trace: Optional[Trace] = None

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        import torch
        with torch.profiler.record_function(name):
            yield

    def start(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self.profile = profile(activities=activities)
            self.profile.__enter__()

    def stop(self):
        if self.profile is None:
            return
        self.profile.__exit__(None, None, None)
        self.trace = reduce(self.profile.profiler.kineto_results.events())
        self.profile = None


def _is_launch(name: str) -> bool:
    """A host call that launches one kernel (runtime or driver API)."""
    return name.startswith("cu") and "Launch" in name and "Kernel" in name


def _interval(event):
    start = event.start_ns()
    return start, start + event.duration_ns()


def reduce(events) -> Trace:
    """The window's device operations, busy time and idle gaps."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    window, spans, ops, launches = None, [], [], []
    for event in events:
        name = event.name()
        if event.device_type() == cuda:
            # Synchronisation records and the spans' own device-side
            # copies (user annotations) are not work.
            if ("Sync" in name or name == "window" or name in SPANS
                    or getattr(event, "is_user_annotation", bool)()):
                continue
            ops.append(DeviceOp(name, *_interval(event)))
        elif name == "window":
            window = _interval(event)
        elif name in SPANS:
            spans.append(DeviceOp(name, *_interval(event)))
        elif _is_launch(name):
            launches.append(event.start_ns())
    if window is None:
        raise RuntimeError("the trace holds no 'window' span")
    start, end = window
    ops = sorted((op for op in ops if op.end_ns > start and op.start_ns < end),
                 key=lambda op: op.start_ns)
    busy, gaps, cursor = 0, [], start
    for op in ops:
        begin, finish = max(op.start_ns, start), min(op.end_ns, end)
        if begin > cursor:
            gaps.append((begin - cursor, cursor))
        if finish > cursor:
            busy += finish - max(begin, cursor)
            cursor = finish
    if end > cursor:
        gaps.append((end - cursor, cursor))
    gaps.sort(key=lambda gap: -gap[0])
    named = [(length / 1e9, _open_span(spans, at))
             for length, at in gaps[:10]]
    harness = [s for s in spans if s.name == HARNESS_SPAN
               and s.end_ns > start and s.start_ns < end]
    own = sum(1 for at in launches
              if any(s.start_ns <= at < s.end_ns for s in harness))
    return Trace(ops, (end - start) / 1e9, busy / 1e9, named, own)


def _open_span(spans: List[DeviceOp], at: int) -> str:
    """The innermost benchmark span open on the host at ``at``."""
    open_ = [s for s in spans if s.start_ns <= at < s.end_ns]
    if not open_:
        return "between_units"
    return min(open_, key=lambda s: s.end_ns - s.start_ns).name
