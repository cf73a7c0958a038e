"""Operations and bytes that the inputs need, and the chip's peaks.

The counts of kernels 1 to 4 are frozen copies of ``chip_smoke.py``'s
``attention_work``, ``decode_block_work`` and ``teacher_forced_work`` (at
commit cacbdcd), with one change: kernels 3 and 4 and the helper are
counted over the row-steps the targets need (``row_steps``, each row up
to its target length), not over every padded row-step, as kernel 2 is
counted over the row-steps that emit. A kernel that skips padding is then
credited, and no count depends on which implementation ran.
"""

from typing import Tuple

# NVIDIA H100 SXM data sheet, 700 W: float32 outside the tensor cores (the
# configurations are float32 with TF32 off), and HBM3 bandwidth.
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(num_bytes: float, flops: float) -> float:
    """The least seconds the chip needs for this work."""
    return max(num_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def decoder_step_products(h: int, e: int, vocab: int) -> int:
    """Multiply-adds of one decoder row-step's products: the textual
    query, the visual query (2H -> H) and its projection, the LSTM's input
    (E + 2H -> 4H) and recurrent (H -> 4H) products, and the head
    (E + 3H -> H -> V)."""
    return (h * h + 2 * h * h + h * h + (e + 2 * h) * 4 * h + h * 4 * h
            + (e + 3 * h) * h + h * vocab)


def decoder_step_flops(h: int, e: int, vocab: int, m_t: int, m_v: int) -> int:
    """Operations of one decoder row-step: its products, both attentions
    and the cell."""
    return (2 * decoder_step_products(h, e, vocab)
            + (m_t + m_v) * (6 * h + 5) + 12 * h)


def decode_block_work(batch: int, m_t: int, m_v: int, h: int, vocab: int,
                      steps: int, weights_bytes: int,
                      row_steps: int) -> Tuple[int, int]:
    """(bytes, flops) of one kernel 2 launch. Bytes: the keys, mask and
    state read once, the weights once, the state and per-step outputs
    written once. Flops: the ``row_steps`` emitting row-steps of the
    launch (a done row's step needs nothing). The decoder's token
    embedding has width H."""
    read = 4 * (batch * m_t * h + batch * m_t + batch * m_v * h
                + 2 * batch * h + batch) + batch + weights_bytes
    written = (4 * (2 * batch * h + batch + steps * batch * (2 + m_t + m_v))
               + batch)
    return read + written, row_steps * decoder_step_flops(h, h, vocab, m_t,
                                                          m_v)


def decoder_weights_bytes(h: int, vocab: int) -> int:
    """Bytes of kernel 2's packed decoder weights (float32)."""
    return 4 * (h * h + h + 2 * h * h + h + h * h + h + vocab * h
                + 3 * h * 4 * h + h * 4 * h + 4 * h + 4 * h * h + h * vocab)


def teacher_forced_work(batch: int, row_steps: int, m_t: int, m_v: int,
                        h: int, e: int, vocab: int):
    """((bytes, flops) of kernel 3, of kernel 4, of the weight-gradient
    helper) for ``batch`` rows whose targets need ``row_steps`` row-steps
    in all: each input read once, each output written once. Kernel 4
    recomputes a row-step's forward and adds the transposed products,
    about 10 flops per (key, feature) of the attentions' backward and the
    cell's backward."""
    weights = (h * h + h + 2 * h * h + h + h * h + h + vocab * e
               + (e + 2 * h) * 4 * h + h * 4 * h + 4 * h + (e + 3 * h) * h
               + h * vocab)
    fwd = decoder_step_flops(h, e, vocab, m_t, m_v)
    bwd_products = (vocab * h + h * (e + 3 * h) + 4 * h * (e + 2 * h)
                    + 4 * h * h + h * h + 2 * h * h + h * h)
    bwd = fwd + 2 * bwd_products + (m_t + m_v) * (10 * h + 4) + 30 * h
    n = row_steps
    keys = batch * (m_t * h + m_t + m_v * h)
    width = vocab + 2 * e + 15 * h
    forward = (4 * (n + n * e + keys + 2 * batch * h + n * vocab + 2 * n * h
                    + batch * m_v + weights), n * fwd)
    backward = (4 * (n + n * e + keys + 2 * n * h + n * vocab + batch * m_v
                     + 2 * weights + batch * (m_t + m_v) * h + 2 * batch * h
                     + n * width), n * bwd)
    helper = (4 * (n * width + n * h + n * vocab + weights), 2 * n * weights)
    return forward, backward, helper


def conv_taps(kernel: int, grid: int) -> int:
    """Kernel taps that fall inside a ``grid`` x ``grid`` input, summed
    over every output cell of a same-padded square convolution (the
    padding's zeros need no work)."""
    half = kernel // 2
    line = sum(min(grid - 1, i + half) - max(0, i - half) + 1
               for i in range(grid))
    return line * line


def encoder_flops(cfg: dict, input_lengths, grid: int,
                  channels: int) -> int:
    """Forward operations of the encoder for rows of these command
    lengths: the three convolutions over the grid (taps inside it), the
    BiLSTM over each row's tokens, both key projections and the decoder's
    initial state."""
    e, he = cfg["embedding_dimension"], cfg["encoder_hidden_size"]
    h, o, k = (cfg["decoder_hidden_size"], cfg["cnn_hidden_num_channels"],
               cfg["cnn_kernel_size"])
    rows = len(input_lengths)
    tokens = int(sum(int(n) for n in input_lengths))
    grid_cells = grid * grid
    conv = rows * 2 * channels * o * sum(conv_taps(size, grid)
                                         for size in (1, 5, k))
    lstm = tokens * 2 * (2 * 4 * he * (e + he) + 12 * he)
    keys = 2 * (tokens * he * h + rows * grid_cells * 3 * o * h)
    init = rows * 2 * he * h
    return conv + lstm + keys + init
