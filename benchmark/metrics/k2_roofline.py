"""k2_roofline: kernel 2 (the decode block, ``ops/decode_block.py``), all
launches of the traced batches: the least time they need, each launch
counted over the row-steps that emit in it, over their device time in
the trace."""

import math

import numpy as np

from benchmark.harness.work import (bound_s, decode_block_work,
                                    decoder_weights_bytes)

KERNELS = ("decode_block_kernel", "decode_grid_kernel")


def read(ctx):
    c = ctx.counts
    seconds = ctx.trace.seconds(KERNELS)
    if c.get("kind") != "decode" or seconds <= 0:
        return None
    h, v, block = c["hidden"], c["vocab"], c["block"]
    need = 0.0
    for lengths in c["lengths"]:
        lengths = np.asarray(lengths, np.int64)
        launches = min(math.ceil(int(lengths.max()) / block),
                       math.ceil(c["steps"] / block))
        for b in range(max(1, launches)):
            row_steps = int(np.clip(lengths - b * block, 0, block).sum())
            need += bound_s(*decode_block_work(
                c["batch"], c["m_t"], c["m_v"], h, v, block,
                decoder_weights_bytes(h, v), row_steps))
    return 100.0 * need / seconds
