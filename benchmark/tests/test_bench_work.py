"""The benchmark's counts of operations and bytes against hand counts."""

from benchmark.harness import work


def test_conv_taps_count_only_cells_inside_the_grid():
    assert work.conv_taps(1, 6) == 36
    # Kernel 5 on 6 cells: 3, 4, 5, 5, 4, 3 taps a line.
    assert work.conv_taps(5, 6) == 24 * 24
    # Kernel 7: 4, 5, 6, 6, 5, 4.
    assert work.conv_taps(7, 6) == 30 * 30
    assert work.conv_taps(3, 1) == 1


def test_decoder_step_flops_by_hand():
    h, v, m_t, m_v = 2, 3, 1, 2
    # Products: txt query 4, q2k 8, vis query 4, W_ih (e + 2h = 6 -> 8) 48,
    # W_hh 16, head (e + 3h = 8 -> 2) 16 and 6: 102 multiply-adds.
    assert work.decoder_step_products(h, h, v) == 102
    assert work.decoder_step_flops(h, h, v, m_t, m_v) == (
        2 * 102 + 3 * (6 * 2 + 5) + 12 * 2)


def test_bound_takes_the_slower_side():
    assert work.bound_s(3.35e12, 0) == 1.0
    assert work.bound_s(0, 67e12) == 1.0
    assert work.bound_s(3.35e12, 2 * 67e12) == 2.0


def test_teacher_forced_work_counts_the_row_steps_given():
    full = work.teacher_forced_work(4, 40, 3, 5, 8, 8, 9)
    half = work.teacher_forced_work(4, 20, 3, 5, 8, 8, 9)
    for a, b in zip(full, half):
        assert a[1] == 2 * b[1]      # operations scale with row-steps
        assert a[0] > b[0]           # bytes keep the per-row terms
    assert full[0][1] == 40 * work.decoder_step_flops(8, 8, 9, 3, 5)


def test_decode_block_work_by_hand():
    batch, m_t, m_v, h, v, steps = 2, 1, 1, 1, 2, 3
    weights = work.decoder_weights_bytes(h, v)
    num_bytes, flops = work.decode_block_work(batch, m_t, m_v, h, v, steps,
                                              weights, row_steps=5)
    read = 4 * (2 + 2 + 2 + 4 + 2) + 2 + weights
    written = 4 * (4 + 2 + 3 * 2 * 4) + 2
    assert num_bytes == read + written
    assert flops == 5 * work.decoder_step_flops(1, 1, 2, 1, 1)


def test_encoder_flops_by_hand():
    cfg = dict(embedding_dimension=1, encoder_hidden_size=1,
               decoder_hidden_size=1, cnn_hidden_num_channels=1,
               cnn_kernel_size=1)
    # One row, one token, a 1 x 1 grid of 1 channel: each convolution one
    # tap (2 flops, 3 convolutions), the LSTM 2 directions x (2 x 4 x 2 +
    # 12), the keys 2 x (1 + 3), the initial state 2.
    assert work.encoder_flops(cfg, [1], 1, 1) == 6 + 2 * 28 + 8 + 2
