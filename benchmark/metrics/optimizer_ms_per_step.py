"""optimizer_ms_per_step: the device ms a training step spends in the
program's ``gscan.step.optimizer`` spans (Adam's update of every leaf and
the write of the new state into the chunk's buffer), over the steps of
the traced window's last chunk. In the chunk's CUDA graph the spans are
device markers that each replay rewrites, so every chunk's read the last
replay's times; Adam's work has fixed shapes, so each chunk does the
same."""

from benchmark.harness import program_spans


def read(ctx):
    if ctx.counts.get("kind") != "train":
        return None
    spans = program_spans.window_spans(ctx)
    chunks = program_spans.roots(spans, "gscan.chunk")
    if not chunks:
        return None
    last = chunks[-1]
    times = [s.device_ms() for s in spans if s.root == last.id
             and s.name == "gscan.step.optimizer"]
    if not times or None in times or not last.counts.get("steps"):
        return None
    return sum(times) / last.counts["steps"]
