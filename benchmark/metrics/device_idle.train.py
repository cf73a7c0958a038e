"""device_idle.train: the share of the traced training window in which no
operation ran on the device (overlapping operations counted once)."""


def read(ctx):
    if ctx.counts.get("kind") != "train" or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
