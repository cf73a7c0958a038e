"""launches_per_step.train: device kernels in the trace per traced
training step (the encoder, autograd's small kernels and Adam's, beside
kernels 3, 4 and the helper)."""


def read(ctx):
    c = ctx.counts
    if c.get("kind") != "train" or not c["steps"]:
        return None
    return len(ctx.trace.kernels()) / c["steps"]
