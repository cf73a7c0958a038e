"""decode_mfu: the operations the traced batches need (the encoder over
each row's command, and the decoder over the row-steps that emit) over
the traced window's time, as a share of the chip's float32 peak."""

from benchmark.harness.work import (F32_FLOPS_PER_S, decoder_step_flops,
                                    encoder_flops)


def read(ctx):
    c = ctx.counts
    if c.get("kind") != "decode" or not c["batches"]:
        return None
    h, v = c["hidden"], c["vocab"]
    need = sum(
        encoder_flops(ctx.config, commands, c["grid"], c["channels"])
        + int(lengths.sum()) * decoder_step_flops(h, h, v, c["m_t"],
                                                  c["m_v"])
        for commands, lengths in zip(c["input_lengths"], c["lengths"]))
    return 100.0 * need / ctx.trace.window_s / F32_FLOPS_PER_S
