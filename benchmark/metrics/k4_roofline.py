"""k4_roofline: kernel 4 and its weight-gradient helper (the teacher-forced
backward, ``ops/teacher_forced.py``), both launches of a step together:
the least time they need, counted over the row-steps the targets need,
over their device time in the trace."""

from benchmark.harness.work import bound_s, teacher_forced_work

KERNELS = ("backward_cluster_kernel", "backward_grid_kernel", "weight_grads")


def read(ctx):
    c = ctx.counts
    seconds = ctx.trace.seconds(KERNELS)
    if c.get("kind") != "train" or seconds <= 0:
        return None
    need = 0.0
    for n in c["row_steps"]:
        _, backward, helper = teacher_forced_work(
            c["batch"], n, c["m_t"], c["m_v"], c["hidden"], c["hidden"],
            c["vocab"])
        need += bound_s(*backward) + bound_s(*helper)
    return 100.0 * need / seconds
