"""The program's own spans and counters in a ``--trace 1`` window.

The port records them (``multimodal_seq2seq_gscan_tpu_torch/utils/
profiling.py``, ``recorder``) while a torch profiler runs: in a benchmark
process, the unit before the window and the window's units. Each span
has a name, its root's id, its parent's id, its counts, its host start
and end in Unix-epoch ns (the clock of the device trace's events) and
its device ms (``device_ms()``, None without a device). A program without
the recorder gives no spans, and the readers of them then nothing.

The window's spans are those that end after its first device operation:
the unit before the window ends, synchronised, before the window opens.
Without device operations (the CPU), they are the spans of every root
but the first (the harness runs one unit under the profiler before the
window).

The window's idle gaps are found in ``trace.ops`` by ``trace.reduce``'s
union rule, between its first operation and its last, and each is named
by the innermost program span open on the host when it began (the
shortest), as ``reduce`` names its gaps by the harness's spans. In the
decode a program span that syncs leaves the device queue empty, so the
gap that follows is its own.
"""

from typing import Dict, List, Optional


def recorded() -> list:
    """Every span the program's recorder holds, oldest first."""
    try:
        from multimodal_seq2seq_gscan_tpu_torch.utils import profiling
    except ImportError:
        return []
    recorder = getattr(profiling, "recorder", None)
    return [] if recorder is None else recorder.spans()


def window_spans(ctx) -> list:
    spans = recorded()
    if ctx.trace.ops:
        first = ctx.trace.ops[0].start_ns
        return [s for s in spans if s.end_ns > first]
    first_root = next((s.id for s in spans if s.parent is None), None)
    return [s for s in spans if s.root != first_root]


def roots(spans, name: str) -> list:
    return [s for s in spans if s.parent is None and s.name == name]


def idle_gaps(ops) -> List[tuple]:
    """(start ns, length ns) of each gap in the union of ``ops``' device
    intervals, between the first operation and the last."""
    gaps, cursor = [], None
    for op in sorted(ops, key=lambda op: op.start_ns):
        if cursor is not None and op.start_ns > cursor:
            gaps.append((cursor, op.start_ns - cursor))
        cursor = op.end_ns if cursor is None else max(cursor, op.end_ns)
    return gaps


def idle_by_span(ctx, spans) -> Dict[str, float]:
    """Seconds of the window's idle gaps by the name of the innermost
    program span open when each began (gaps outside every span left
    out)."""
    seconds: Dict[str, float] = {}
    for at, length in idle_gaps(ctx.trace.ops):
        open_ = [s for s in spans if s.start_ns <= at < s.end_ns]
        if open_:
            name = min(open_, key=lambda s: s.end_ns - s.start_ns).name
            seconds[name] = seconds.get(name, 0.0) + length / 1e9
    return seconds


def idle_share(ctx, kind: str, names) -> Optional[float]:
    """% of the traced window idle in gaps begun in the spans ``names``;
    None without device operations or program spans."""
    if ctx.counts.get("kind") != kind or not ctx.trace.ops \
            or ctx.trace.window_s <= 0:
        return None
    spans = window_spans(ctx)
    if not spans:
        return None
    idle = idle_by_span(ctx, spans)
    return 100.0 * sum(idle.get(n, 0.0) for n in names) / ctx.trace.window_s
