"""On the card: each CUDA kernel of the port equals its plain PyTorch version.

These tests import no JAX (the card's machine has none) and skip where
``torch.cuda.is_available()`` is false. Run them on the card, where
tests/conftest.py cannot load (it imports JAX), with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Bars are the JAX package's for its own kernels: attention context atol 1e-5
and weights atol 1e-6 (tests/test_pallas_attention.py); decode-block tokens,
done and emitted flags equal, attention rtol 1e-5 / atol 1e-6
(tests/test_pallas_decoder.py), here also for the carried h and c;
teacher-forced logits rtol/atol 1e-5, summed attention rtol 1e-5 / atol
1e-6 and gradients rtol 2e-4 / atol 2e-5
(tests/test_pallas_teacher_forced.py), with kernel 4 and its weight-gradient
helper bit-identical from run to run (also at ragged shapes: B=203, T=1, a
row-step count that is not a multiple of the helper's chunks, fewer rows
than one cluster). Every kernel also takes shapes past the
register-resident attention and past the resident weight slices of kernels
3 and 4 (a 9x9 grid, H=E=136, H=E=256 with M_t=72 and a 12x12 grid), at the
same bars. Kernel 1's gradients (its backward is the plain
``attention_vjp_plain``) match autograd through its plain version at rtol
1e-4 / atol 1e-5, the bar of float32 sums in two orders.
"""

import numpy as np
import pytest
import torch

from multimodal_seq2seq_gscan_tpu_torch.ops import additive_attention as k1
from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2


def attention_inputs(seed, batch, m, h, lengths=None):
    rng = np.random.RandomState(seed)
    pq = rng.randn(batch, h).astype(np.float32)
    keys = rng.randn(batch, m, h).astype(np.float32)
    energy = (rng.randn(h, 1) / np.sqrt(h)).astype(np.float32)
    mask = None
    if lengths is not None:
        mask = (np.arange(m)[None, :] < np.asarray(lengths)[:, None]
                ).astype(np.float32)
    return pq, keys, mask, energy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,masked", [(16, True), (36, False)])
def test_attention_kernel_matches_plain(cuda, m, masked):
    batch, h = 4096, 100
    lengths = np.random.RandomState(1).randint(0, m + 1, size=batch) \
        if masked else None
    pq, keys, mask, energy = [
        None if a is None else torch.from_numpy(a).to(cuda)
        for a in attention_inputs(3, batch, m, h, lengths)]
    before = k1.launches
    ctx, w = k1.additive_attention(pq, keys, mask, energy)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    ctx_ref, w_ref = k1.additive_attention_plain(pq, keys, mask, energy)
    torch.testing.assert_close(ctx, ctx_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(w, w_ref, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_attention_kernel_rejects_bad_input(cuda):
    pq, keys, _, energy = [torch.from_numpy(a).to(cuda) if a is not None
                           else None for a in attention_inputs(0, 4, 8, 16)]
    with pytest.raises(TypeError):
        k1.additive_attention(pq.double(), keys, None, energy)
    with pytest.raises(ValueError):
        k1.additive_attention(pq, keys.transpose(1, 2), None, energy)
    with pytest.raises(ValueError):
        k1.additive_attention(pq, keys, None, energy.cpu())


@pytest.mark.cuda
def test_decode_block_kernel_matches_plain(cuda):
    """Flagship widths, random weights, B not a multiple of the CTA rows."""
    batch, m_t, m_v, h, vocab, steps = 1000, 16, 36, 100, 9, 12
    rng = np.random.RandomState(5)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).to(cuda)

    weights = k2.DecoderWeights(
        t(h, h, scale=0.1), t(h, 1, scale=0.1), t(2 * h, h, scale=0.07),
        t(1, h, scale=0.1), t(h, h, scale=0.1), t(h, 1, scale=0.1),
        t(vocab, h), t(3 * h, 4 * h, scale=0.06), t(h, 4 * h, scale=0.1),
        t(1, 4 * h, scale=0.1), t(4 * h, h, scale=0.05),
        t(h, vocab, scale=0.3))
    weights.embedding[0] = 0.0
    lengths = torch.from_numpy(rng.randint(1, m_t + 1, size=batch)).to(cuda)
    mask = (torch.arange(m_t, device=cuda)[None] < lengths[:, None]).float()
    args = (t(batch, m_t, h), mask, t(batch, m_v, h), t(batch, h, scale=0.5),
            t(batch, h, scale=0.5),
            torch.full((batch,), 1, dtype=torch.int32, device=cuda),
            torch.from_numpy(rng.rand(batch) < 0.1).to(cuda), weights)
    before = k2.launches
    out = k2.fused_decode_block(*args, num_steps=steps, eos_idx=2)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    ref = k2.decode_block_plain(*args, num_steps=steps, eos_idx=2)
    for name in ("tokens", "done", "step_tokens", "step_emitted"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    for name in ("step_attn_cmd", "step_attn_sit", "h", "c"):
        torch.testing.assert_close(getattr(out, name), getattr(ref, name),
                                   rtol=1e-5, atol=1e-6)


def teacher_forced_inputs(device, batch, steps, num_steps, m_t=16, m_v=36,
                          h=100, vocab=9, seed=0):
    """Flagship widths; weights drawn as the JAX package initialises them,
    N(0, 1) keys, command lengths in 1..M_t, a p=0.3 dropout mask, tokens
    uniform over the vocabulary with pad past num_steps."""
    rng = np.random.RandomState(seed)

    def t(array):
        return torch.from_numpy(np.asarray(array, np.float32)).to(device)

    def uniform(shape, fan_in):
        return t(rng.uniform(-1, 1, shape) / np.sqrt(fan_in))

    embedding = rng.randn(vocab, h)
    embedding[0] = 0.0
    weights = k2.DecoderWeights(
        uniform((h, h), h), uniform((h, 1), h), uniform((2 * h, h), 2 * h),
        uniform((1, h), 2 * h), uniform((h, h), h), uniform((h, 1), h),
        t(embedding), uniform((3 * h, 4 * h), h), uniform((h, 4 * h), h),
        uniform((1, 4 * h), h), uniform((4 * h, h), 4 * h),
        uniform((h, vocab), h))
    lengths = rng.randint(1, m_t + 1, size=batch)
    mask = t(np.arange(m_t)[None] < lengths[:, None])
    tokens = rng.randint(0, vocab, size=(steps, batch))
    tokens[num_steps:] = 0
    drop = (rng.rand(steps, batch, h) > 0.3) / 0.7
    h0 = np.tanh(rng.randn(batch, h))
    inputs = (t(rng.randn(batch, m_t, h)), mask, t(rng.randn(batch, m_v, h)),
              t(h0), t(rng.randn(batch, h) * 0.5),
              torch.from_numpy(tokens.astype(np.int32)).to(device), t(drop),
              weights)
    cotangents = (t(rng.randn(steps, batch, vocab)),
                  t(rng.randn(batch, m_v)))
    return inputs, cotangents


@pytest.mark.cuda
def test_teacher_forced_kernels_match_plain(cuda):
    """Kernel 3 and kernel 4 + the weight-gradient helper against the plain
    unroll and its autograd gradients, at the JAX tests' bars (logits rtol/atol
    1e-5, summed attention atol 1e-6; gradients rtol 2e-4 / atol 2e-5), on a
    batch that is not a multiple of the CTA rows and with time padding."""
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    batch, steps, num_steps = 37, 13, 11
    inputs, (w_log, w_asum) = teacher_forced_inputs(cuda, batch, steps,
                                                    num_steps)
    before = dict(tf.launches)
    logits, h_res, c_res, asum = tf.teacher_forced_forward(
        *inputs, num_steps=num_steps)
    torch.cuda.synchronize()
    differentiable = [inputs[0], inputs[2], inputs[3], inputs[4],
                      *inputs[7]]
    leaves = [x.clone().requires_grad_(True) for x in differentiable]
    plain_inputs = (leaves[0], inputs[1], leaves[1], leaves[2], leaves[3],
                    inputs[5], inputs[6], k2.DecoderWeights(*leaves[4:]))
    ref_logits, ref_asum = tf.teacher_forced_plain(*plain_inputs,
                                                   num_steps=num_steps)
    torch.testing.assert_close(logits[:num_steps], ref_logits[:num_steps],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(asum, ref_asum, rtol=1e-5, atol=1e-6)

    dlogits = torch.zeros_like(logits)
    dlogits[:num_steps] = w_log[:num_steps]
    ref_grads = torch.autograd.grad(
        (ref_logits * dlogits).sum() + (ref_asum * w_asum).sum(), leaves)
    outs = tf.teacher_forced_backward(
        inputs[0], inputs[1], inputs[2], inputs[5], inputs[6], inputs[7],
        h_res, c_res, dlogits, w_asum, num_steps=num_steps)
    grads = list(outs[:4]) + list(tf.teacher_forced_weight_grads(
        outs[4], h_res, dlogits))
    torch.cuda.synchronize()
    names = ["proj_txt", "proj_vis", "h0", "c0"] + list(
        k2.DecoderWeights._fields)
    for name, got, want in zip(names, grads, ref_grads):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5,
                                   msg=name)
    assert tf.launches["teacher_forced_forward"] \
        == before["teacher_forced_forward"] + 1
    assert tf.launches["teacher_forced_backward"] \
        == before["teacher_forced_backward"] + 1
    assert tf.launches["teacher_forced_weight_grads"] \
        == before["teacher_forced_weight_grads"] + 1

    # Kernel 4 and the helper again on the same inputs: every bit the same.
    again = tf.teacher_forced_backward(
        inputs[0], inputs[1], inputs[2], inputs[5], inputs[6], inputs[7],
        h_res, c_res, dlogits, w_asum, num_steps=num_steps)
    again = list(again[:4]) + list(tf.teacher_forced_weight_grads(
        again[4], h_res, dlogits))
    for name, first, second in zip(names, grads, again):
        assert torch.equal(first, second), name


@pytest.mark.cuda
def test_attention_backward_on_card(cuda):
    """Kernel 1 under autograd: its gradients equal those of the plain
    version (the backward is the same plain function on both)."""
    pq, keys, mask, energy = [
        torch.from_numpy(a).to(cuda) if a is not None else None
        for a in attention_inputs(4, 64, 16, 100,
                                  np.random.RandomState(2).randint(
                                      1, 17, size=64))]
    cot_c = torch.randn(64, 100, device=cuda)
    cot_w = torch.randn(64, 16, device=cuda)
    grads = []
    for fn in (k1.additive_attention, k1.additive_attention_plain):
        leaves = [x.clone().requires_grad_(True) for x in (pq, keys, energy)]
        ctx, w = fn(leaves[0], leaves[1], mask, leaves[2])
        grads.append(torch.autograd.grad(
            (ctx * cot_c).sum() + (w * cot_w).sum(), leaves))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_attention_without_grad_launches_directly(cuda):
    """With no gradient wanted, kernel 1 runs without an autograd node."""
    pq, keys, mask, energy = [
        torch.from_numpy(a).to(cuda) if a is not None else None
        for a in attention_inputs(5, 8, 16, 100,
                                  np.random.RandomState(3).randint(
                                      1, 17, size=8))]
    before = k1.launches
    leaf = pq.clone().requires_grad_(True)
    with torch.no_grad():
        ctx, w = k1.additive_attention(leaf, keys, mask, energy)
    assert ctx.grad_fn is None and w.grad_fn is None
    ctx, w = k1.additive_attention(leaf, keys, mask, energy)
    assert ctx.grad_fn is not None
    assert k1.launches == before + 2


@pytest.mark.cuda
def test_decode_block_refuses_grad(cuda):
    weights = k2.DecoderWeights(*(torch.zeros(s, device=cuda) for s in (
        (8, 8), (8, 1), (16, 8), (1, 8), (8, 8), (8, 1), (9, 8), (24, 32),
        (8, 32), (1, 32), (32, 8), (8, 9))))
    h = torch.zeros(2, 8, device=cuda, requires_grad=True)
    args = (torch.zeros(2, 3, 8, device=cuda), torch.ones(2, 3, device=cuda),
            torch.zeros(2, 4, 8, device=cuda), h, h.detach(),
            torch.ones(2, dtype=torch.int32, device=cuda),
            torch.zeros(2, dtype=torch.bool, device=cuda), weights)
    with pytest.raises(RuntimeError):
        k2.fused_decode_block(*args, num_steps=2, eos_idx=2)


def kernel4_and_helper(inputs, dlogits, g_asum, num_steps):
    """Kernel 3's residuals, then kernel 4 and the helper: (the 4 per-row
    gradients and the stash, the 12 weight gradients, h_res)."""
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    _, h_res, c_res, _ = tf.teacher_forced_forward(*inputs,
                                                   num_steps=num_steps)
    raw = tf.teacher_forced_backward(
        inputs[0], inputs[1], inputs[2], inputs[5], inputs[6], inputs[7],
        h_res, c_res, dlogits, g_asum, num_steps=num_steps)
    grads = tf.teacher_forced_weight_grads(raw[4], h_res, dlogits)
    torch.cuda.synchronize()
    return list(raw), list(grads), (h_res, c_res)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,steps,num_steps", [
    (203, 13, 11),   # B not a multiple of the rows per cluster
    (16, 1, 1),      # T = 1
    (200, 7, 7),     # N = 1400 row-steps, not a multiple of the chunks
    (5, 3, 2)])      # smaller than one cluster's rows
def test_kernel4_and_helper_match_plain_twins(cuda, batch, steps, num_steps):
    """Kernel 4 (one cluster per row group) against its plain twin
    ``teacher_forced_backward_plain`` and the helper (split over chunks of
    row-steps) against ``weight_grads_plain``, on the same residuals, at
    the gradient bar (rtol 2e-4 / atol 2e-5); each run twice, every bit the
    same."""
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    inputs, (dlogits, g_asum) = teacher_forced_inputs(
        cuda, batch, steps, num_steps, seed=batch + steps)
    dlogits[num_steps:] = 0.0
    raw, grads, (h_res, c_res) = kernel4_and_helper(inputs, dlogits, g_asum,
                                                    num_steps)
    plain = tf.teacher_forced_backward_plain(
        inputs[0], inputs[1], inputs[2], inputs[5], inputs[6], inputs[7],
        h_res, c_res, dlogits, g_asum, num_steps=num_steps)
    names = ["d_proj_txt", "d_proj_vis", "dh0", "dc0", "stash"]
    for name, got, want in zip(names, raw, plain):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5,
                                   msg=name)
    plain_grads = tf.weight_grads_plain(raw[4], h_res, dlogits)
    for name, got, want in zip(k2.DecoderWeights._fields, grads,
                               plain_grads):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5,
                                   msg=name)
    again_raw, again_grads, _ = kernel4_and_helper(inputs, dlogits, g_asum,
                                                   num_steps)
    for name, first, second in zip(names + list(k2.DecoderWeights._fields),
                                   raw + grads, again_raw + again_grads):
        assert torch.equal(first, second), name


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [53, 56])
def test_forward_kernel_matches_plain(cuda, steps):
    """Kernel 3 at the training shapes (B=200, num_steps=53; T=56 has 3 pad
    steps) against its plain version: logits rtol/atol 1e-5 and the summed
    attention rtol 1e-5 / atol 1e-6 (the JAX tests' bars), the residual
    state at the logits' bar; run twice, every bit the same."""
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    num_steps = 53
    inputs, _ = teacher_forced_inputs(cuda, 200, steps, num_steps, seed=steps)
    before = tf.launches["teacher_forced_forward"]
    got = tf.teacher_forced_forward(*inputs, num_steps=num_steps)
    again = tf.teacher_forced_forward(*inputs, num_steps=num_steps)
    torch.cuda.synchronize()
    assert tf.launches["teacher_forced_forward"] == before + 2
    want = tf.teacher_forced_forward_plain(*inputs, num_steps=num_steps)
    torch.testing.assert_close(got[0][:num_steps], want[0][:num_steps],
                               rtol=1e-5, atol=1e-5)
    for name, a, b in zip(("h_res", "c_res"), got[1:3], want[1:3]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-6)
    for first, second in zip(got, again):
        assert torch.equal(first, second)


# Shapes past the attention's register-resident form (M <= 64, H <= 128)
# and past kernels 3 and 4 holding the weight slices in shared memory.
WIDE_SHAPES = {
    "W1": dict(h=100, m_t=16, m_v=81),    # a 9x9 grid
    "W2": dict(h=136, m_t=16, m_v=36),
    "W3": dict(h=256, m_t=72, m_v=144),   # masks over 64 keys, a 12x12 grid
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WIDE_SHAPES))
def test_wide_shapes_match_plain(cuda, name):
    """Kernels 1-4 and the helper at a wide shape: each wrapper launches its
    kernel (its count rises) and meets the JAX bars against its plain
    version (attention context atol 1e-5, weights atol 1e-6; decode-block
    tokens equal, attention, h and c rtol 1e-5 / atol 1e-6; teacher-forced
    logits rtol/atol 1e-5, summed attention atol 1e-6, gradients rtol 2e-4
    / atol 2e-5); kernels 3 and 4 and the helper are bit-identical on a
    rerun."""
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    shape = WIDE_SHAPES[name]
    h, m_t, m_v = shape["h"], shape["m_t"], shape["m_v"]
    before = (k1.launches, k2.launches, dict(tf.launches))

    # Kernel 1: the commands (masked, lengths 0..M_t) and the grid.
    for m, lengths in ((m_t, np.random.RandomState(1).randint(
            0, m_t + 1, size=96)), (m_v, None)):
        pq, keys, mask, energy = [
            None if a is None else torch.from_numpy(a).to(cuda)
            for a in attention_inputs(2, 96, m, h, lengths)]
        ctx, w = k1.additive_attention(pq, keys, mask, energy)
        ctx_ref, w_ref = k1.additive_attention_plain(pq, keys, mask, energy)
        torch.testing.assert_close(ctx, ctx_ref, rtol=0, atol=1e-5)
        torch.testing.assert_close(w, w_ref, rtol=0, atol=1e-6)

    # Kernel 2: one block of 8 steps.
    inputs, (w_log, w_asum) = teacher_forced_inputs(
        cuda, 37, 6, 5, m_t=m_t, m_v=m_v, h=h, seed=h + m_v)
    block_args = (inputs[0], inputs[1], inputs[2], inputs[3], inputs[4],
                  torch.ones(37, dtype=torch.int32, device=cuda),
                  torch.zeros(37, dtype=torch.bool, device=cuda), inputs[7])
    out = k2.fused_decode_block(*block_args, num_steps=8, eos_idx=2)
    ref = k2.decode_block_plain(*block_args, num_steps=8, eos_idx=2)
    for field in ("tokens", "done", "step_tokens", "step_emitted"):
        assert torch.equal(getattr(out, field), getattr(ref, field)), field
    for field in ("step_attn_cmd", "step_attn_sit", "h", "c"):
        torch.testing.assert_close(getattr(out, field), getattr(ref, field),
                                   rtol=1e-5, atol=1e-6, msg=field)

    # Kernels 3, 4 and the helper against the plain unroll's autograd.
    num_steps = 5
    logits, h_res, c_res, asum = tf.teacher_forced_forward(
        *inputs, num_steps=num_steps)
    leaves = [x.clone().requires_grad_(True) for x in
              (inputs[0], inputs[2], inputs[3], inputs[4], *inputs[7])]
    ref_logits, ref_asum = tf.teacher_forced_plain(
        leaves[0], inputs[1], leaves[1], leaves[2], leaves[3], inputs[5],
        inputs[6], k2.DecoderWeights(*leaves[4:]), num_steps=num_steps)
    torch.testing.assert_close(logits[:num_steps], ref_logits[:num_steps],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(asum, ref_asum, rtol=1e-5, atol=1e-6)
    dlogits = torch.zeros_like(logits)
    dlogits[:num_steps] = w_log[:num_steps]
    ref_grads = torch.autograd.grad(
        (ref_logits * dlogits).sum() + (ref_asum * w_asum).sum(), leaves)
    raw, grads, _ = kernel4_and_helper(inputs, dlogits, w_asum, num_steps)
    names = ["proj_txt", "proj_vis", "h0", "c0"] + list(
        k2.DecoderWeights._fields)
    for field, got, want in zip(names, raw[:4] + grads, ref_grads):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5,
                                   msg=field)
    forward_again = tf.teacher_forced_forward(*inputs, num_steps=num_steps)
    raw_again, grads_again, _ = kernel4_and_helper(inputs, dlogits, w_asum,
                                                   num_steps)
    for first, second in zip(
            [logits, h_res, c_res, asum] + raw + grads,
            list(forward_again) + raw_again + grads_again):
        assert torch.equal(first, second)

    after = (k1.launches, k2.launches, dict(tf.launches))
    assert after[0] == before[0] + 2 and after[1] == before[1] + 1
    for kernel, count in after[2].items():
        assert count > before[2][kernel], kernel
