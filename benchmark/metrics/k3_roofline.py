"""k3_roofline: kernel 3 (the teacher-forced forward, ``ops/
teacher_forced.py``): the least time its launches need, counted over the
row-steps the targets need, over their device time in the trace."""

from benchmark.harness.work import bound_s, teacher_forced_work

KERNELS = ("forward_cluster_kernel", "forward_grid_kernel")


def read(ctx):
    c = ctx.counts
    seconds = ctx.trace.seconds(KERNELS)
    if c.get("kind") != "train" or seconds <= 0:
        return None
    need = sum(bound_s(*teacher_forced_work(
        c["batch"], n, c["m_t"], c["m_v"], c["hidden"], c["hidden"],
        c["vocab"])[0]) for n in c["row_steps"])
    return 100.0 * need / seconds
