"""device_idle.decode_syncs: the share of the traced decode window idle in
gaps begun while the host was in the program's ``gscan.decode.check_inputs``
or ``gscan.decode.exit_check`` spans: the turnaround of its host syncs."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.idle_share(ctx, "decode", (
        "gscan.decode.check_inputs", "gscan.decode.exit_check"))
