"""decode_blocks_per_batch: kernel 2 launches per traced batch, the blocks
of 32 steps that the early exit lets run."""

KERNELS = ("decode_block_kernel", "decode_grid_kernel")


def read(ctx):
    c = ctx.counts
    if c.get("kind") != "decode" or not c["batches"]:
        return None
    launches = ctx.trace.count(KERNELS)
    return launches / c["batches"] if launches else None
