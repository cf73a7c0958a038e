"""On the card: each CUDA kernel of the port equals its plain PyTorch version.

These tests import no JAX (the card's machine has none) and skip where
``torch.cuda.is_available()`` is false. Run them on the card, where
tests/conftest.py cannot load (it imports JAX), with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Bars are the JAX package's for its own kernels: attention context atol 1e-5
and weights atol 1e-6 (tests/test_pallas_attention.py); decode-block tokens,
done and emitted flags equal, attention rtol 1e-5 / atol 1e-6
(tests/test_pallas_decoder.py), here also for the carried h and c.
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
