"""train_mfu: the model operations of the traced steps (3 x the forward's:
the encoder over each row's command and the decoder over the row-steps
its targets need) over the traced window's time, as a share of the
chip's float32 peak."""

from benchmark.harness.work import (F32_FLOPS_PER_S, decoder_step_flops,
                                    encoder_flops)


def read(ctx):
    c = ctx.counts
    if c.get("kind") != "train" or not c["steps"]:
        return None
    h, v = c["hidden"], c["vocab"]
    forward = sum(
        encoder_flops(ctx.config, lengths, c["grid"], c["channels"])
        + row_steps * decoder_step_flops(h, h, v, c["m_t"], c["m_v"])
        for lengths, row_steps in zip(c["input_lengths"], c["row_steps"]))
    return 100.0 * 3 * forward / ctx.trace.window_s / F32_FLOPS_PER_S
