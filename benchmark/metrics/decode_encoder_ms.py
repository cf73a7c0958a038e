"""decode_encoder_ms: the device ms a traced decode batch spends between
the edges of the program's ``gscan.decode.encode`` span (the CNN, the
BiLSTM, the key projections and the decoder's first state, with the idle
time between their launches), over the window's ``gscan.decode`` calls.

The encoder's ~800 launches pace its device time, and under the profiler
each launch costs the host more: traced it reads ~1.3 to 1.8 times the
untraced span (PERF.md, §3)."""

from benchmark.harness import program_spans


def read(ctx):
    if ctx.counts.get("kind") != "decode":
        return None
    spans = program_spans.window_spans(ctx)
    calls = program_spans.roots(spans, "gscan.decode")
    times = [s.device_ms() for s in spans if s.name == "gscan.decode.encode"]
    if not calls or not times or None in times:
        return None
    return sum(times) / len(calls)
