"""launches_per_batch.decode: device kernels in the trace per traced decode
batch (the encoder's and the gathers beside kernel 2), less the kernels
that the harness launched itself in its ``checksum`` span (the outputs'
checksum and the kept rows of the check's sample)."""


def read(ctx):
    c = ctx.counts
    if c.get("kind") != "decode" or not c["batches"]:
        return None
    return (len(ctx.trace.kernels()) - ctx.trace.harness_launches) \
        / c["batches"]
