"""device_idle.decode_encoder: the share of the traced decode window idle
in gaps begun while the host was in the program's ``gscan.decode.encode``
span: the encoder's launches not keeping up with the device."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.idle_share(ctx, "decode", ("gscan.decode.encode",))
