"""chunk_enqueue_ms: the host ms of the program's ``gscan.chunk`` span (one
resident chunk call: the state's bind copies, Adam's scalars and the
dropout seeds on the host, the two uploads and the graph's launch, each a
child span: ``gscan.chunk.bind``, ``.scalars``, ``.upload``, ``.launch``),
the mean over the traced window's chunks.

Read under the profiler, it is mostly CUPTI's cost of the graph's launch:
tracing the card's activity makes the launch of the baseline chunk's graph
(~85,000 nodes) hold the host ~470 ms against ~42 ms untraced, so a change
in the number of graph nodes moves this metric about ten times its untraced
effect, and one in the host's other work moves it little (PERF.md, §3)."""

from benchmark.harness import program_spans


def read(ctx):
    if ctx.counts.get("kind") != "train":
        return None
    chunks = program_spans.roots(program_spans.window_spans(ctx),
                                 "gscan.chunk")
    if not chunks:
        return None
    return sum(c.end_ns - c.start_ns for c in chunks) / len(chunks) / 1e6
