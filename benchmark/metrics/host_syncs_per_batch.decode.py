"""host_syncs_per_batch.decode: the program's ``host_syncs`` counter (the
input check and each early-exit check) per ``gscan.decode`` call of the
traced window."""

from benchmark.harness import program_spans


def read(ctx):
    if ctx.counts.get("kind") != "decode":
        return None
    calls = program_spans.roots(program_spans.window_spans(ctx),
                                "gscan.decode")
    if not calls:
        return None
    return sum(c.counts.get("host_syncs", 0) for c in calls) / len(calls)
