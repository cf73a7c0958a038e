"""Profiling hooks: a torch.profiler trace over a window of training steps,
and the port's own spans and counters inside any torch.profiler trace.

The port of the JAX package's ``utils/profiling.py``: ``train(profile_dir=)``
traces the steps after its first unit at ``start`` up to ``start + 10``
(the loop passes its first iteration plus 20) into ``profile_dir`` as a
TensorBoard-readable trace (``torch.profiler.tensorboard_trace_handler``:
one ``*.pt.trace.json`` file, the host's calls and, on the card, its
kernels). The first unit (a step, or a resident chunk) runs under the
profiler and its trace is dropped when the next unit starts: it holds the
profiler's own first launches and, in a resident run, the capture of the
marked chunk graph (``train/resident.py``), so the trace shows steady
units.

``span(name)`` and ``count(name)`` mark the port's phases. They are on
exactly while a torch profiler runs (``torch.autograd._profiler_enabled()``:
``--profile_dir``'s window, or any caller's ``torch.profiler.profile``);
off, a span costs that one test. On, a span opens
``torch.profiler.record_function(name)`` (the trace shows it) and keeps a
``SpanRecord`` in ``recorder``, a bounded deque: its name, its root's id
(one for every span of one decode call or one chunk), its parent, its
counts, its host start and end in Unix-epoch ns (the clock of kineto's
events) and, for a ``timed`` span where CUDA is initialised, a pair of
timing events at its edges on the current stream, read as device ms once
its work is done (``SpanRecord.device_ms``). The events are most of a
span's host cost under a profiler (about two thirds of its 45 to 90 us on
an H100's host), so only the spans whose device time is read take them. A
count adds to every open span of the thread, so a root holds its whole
call's counts.

A span opened while the current stream is being captured into a CUDA graph
does no host work that a replay repeats. Inside ``recorder.marking()`` a
timed span's edges become external timing events captured into the graph
(device markers), collected for the graph's owner, which re-enters them with
``recorder.replayed`` after each replay: they then read that replay's
device time. Outside ``marking()`` a captured span keeps nothing.

The spans (timed ones marked *): ``gscan.decode`` (a decode call), with
``gscan.decode.encode``* and ``gscan.decode.check_inputs`` and
``gscan.decode.exit_check`` (each one host sync, counted in
``host_syncs``); ``gscan.chunk`` (a resident chunk call, counting its
``steps``), with ``gscan.chunk.bind``, ``.scalars``, ``.upload`` and
``.launch`` (its host work) and ``gscan.chunk.capture`` (a CUDA graph's
capture); ``gscan.step.optimizer``* (Adam's update, and the resident
graph's write of the new state).
"""

import collections
import contextlib
import itertools
import logging
import threading
import time
from typing import Dict, List, Optional

import torch

logger = logging.getLogger(__name__)

# The most span records kept; older ones are dropped first.
SPAN_CAPACITY = 4096

enabled = torch.autograd._profiler_enabled


class SpanRecord:
    """One span as the recorder keeps it (module docstring)."""

    __slots__ = ("name", "id", "root", "parent", "counts", "start_ns",
                 "end_ns", "events")

    def __init__(self, name: str, id_: int, parent: Optional["SpanRecord"],
                 start_ns: int, events=None):
        self.name, self.id = name, id_
        self.root = id_ if parent is None else parent.root
        self.parent = None if parent is None else parent.id
        self.counts: Dict[str, int] = {}
        self.start_ns = self.end_ns = start_ns
        self.events = events  # (start, end) CUDA timing events, or None

    def device_ms(self) -> Optional[float]:
        """Device ms between the span's edges, once its work is done
        (after a synchronise); None without device events."""
        if self.events is None:
            return None
        return self.events[0].elapsed_time(self.events[1])


class _Off:
    """A span while no profiler runs: nothing."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    def __init__(self, recorder: "Recorder", name: str, timed: bool):
        self.recorder, self.name, self.timed = recorder, name, timed

    def __enter__(self) -> "SpanRecord":
        recorder, events = self.recorder, None
        cuda = torch.cuda.is_initialized()
        self.captured = cuda and torch.cuda.is_current_stream_capturing()
        self.markers = recorder._markers if self.captured else None
        if self.timed and cuda and (self.markers is not None
                                    or not self.captured):
            events = tuple(torch.cuda.Event(enable_timing=True,
                                            external=self.captured)
                           for _ in range(2))
        stack = recorder._stack()
        self.record = SpanRecord(self.name, next(recorder._ids),
                                 stack[-1] if stack else None,
                                 time.time_ns(), events)
        self.function = torch.profiler.record_function(self.name)
        self.function.__enter__()
        if events is not None:
            events[0].record()
        stack.append(self.record)
        return self.record

    def __exit__(self, *exc):
        record = self.record
        if record.events is not None:
            record.events[1].record()
        self.function.__exit__(*exc)
        record.end_ns = time.time_ns()
        self.recorder._stack().pop()
        if not self.captured:
            self.recorder.records.append(record)
        elif self.markers is not None:
            self.markers.append(record)
        return False


class Recorder:
    """The port's spans (module docstring), the last ``capacity`` kept."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.records = collections.deque(maxlen=capacity)
        self._ids = itertools.count()
        self._local = threading.local()
        self._markers: Optional[List[SpanRecord]] = None

    def _stack(self) -> List[SpanRecord]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, timed: bool = False):
        """A context manager: the span ``name`` while a profiler runs,
        with device timing events at its edges if ``timed``."""
        if not enabled():
            return _OFF
        return _Span(self, name, timed)

    def count(self, name: str, n: int = 1):
        """Add ``n`` to the counter ``name`` of every open span."""
        if enabled():
            for record in self._stack():
                record.counts[name] = record.counts.get(name, 0) + n

    def spans(self) -> List[SpanRecord]:
        return list(self.records)

    def clear(self):
        self.records.clear()

    @contextlib.contextmanager
    def marking(self):
        """Around a CUDA graph's capture: gives the list of the device
        markers of the spans captured inside it."""
        self._markers = []
        try:
            yield self._markers
        finally:
            self._markers = None

    def replayed(self, markers: List[SpanRecord]):
        """Re-enter a graph's device markers after a replay, as children
        of the open span, at this host time: each reads the replay's
        device time (until the graph replays again)."""
        if not markers or not enabled():
            return
        stack = self._stack()
        parent = stack[-1] if stack else None
        now = time.time_ns()
        for marker in markers:
            self.records.append(SpanRecord(marker.name, next(self._ids),
                                           parent, now, marker.events))


recorder = Recorder()
span = recorder.span
count = recorder.count


class StepProfiler:
    """Starts a trace at ``start_step`` and stops it at ``stop_step``. Its
    first unit is a warm-up whose trace is dropped when the next unit
    starts; a trace that closes before then keeps it (module docstring)."""

    def __init__(self, profile_dir: Optional[str], start_step: int = 10,
                 num_steps: int = 10):
        self.profile_dir = profile_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._profile = None
        self._phase = None  # "warm-up", "warmed" (its unit done), "steady"

    def maybe_start(self, step: int):
        if self._phase == "warmed":
            self._sync()
            self._profile.step()  # the warm-up's trace is dropped
            self._phase = "steady"
        if self.profile_dir and self._profile is None \
                and step == self.start_step:
            logger.info("Starting torch.profiler trace at step %d -> %s",
                        step, self.profile_dir)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            # Two recorded cycles: the warm-up unit, then the rest.
            self._profile = torch.profiler.profile(
                activities=activities,
                schedule=torch.profiler.schedule(wait=0, warmup=0, active=1,
                                                 repeat=2),
                on_trace_ready=self._ready)
            self._phase = "warm-up"
            self._profile.start()

    def _ready(self, profile):
        if self._phase != "warmed":
            torch.profiler.tensorboard_trace_handler(self.profile_dir)(
                profile)

    def maybe_stop(self, step: int):
        if self._phase == "warm-up":
            self._phase = "warmed"
        elif self._phase == "steady" and step >= self.stop_step:
            self.close()
            logger.info("Stopped torch.profiler trace at step %d", step)

    def _sync(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def close(self):
        if self._profile is not None:
            self._phase = None
            self._sync()
            self._profile.stop()
            self._profile = None
