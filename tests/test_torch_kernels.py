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
same bars, and kernels 1 and 2 also where 16-byte loads do not apply
(H % 4 != 0, or inputs 4 bytes past a 16-byte boundary) and kernel 1 past
H = 1024. Kernel 1's gradients (its backward is the plain
``attention_vjp_plain``) match autograd through its plain version at rtol
1e-4 / atol 1e-5, the bar of float32 sums in two orders. Kernel 2 also
takes H past its ring plans (its grid plan, H = 257 to 2048 and V up to
6,743 here), kernels 3 and 4 and the helper H past their resident plans
(the L2 cluster plans where they are taken, else the grid plans, H = 116
to 1,536, B = 200 at T = 56, B = 5, H = 449 with E = 256; each run twice,
every bit the same, the plan asserted), and the
resident trainer's CUDA graph of the training step gives the eager steps'
state and metrics, also for a decoder of two layers (the step unroll, its
attentions kernel 1); the multi-seed chunk's one graph gives each seed's
single-seed graphed chunk bit for bit, and so does a chunk under a
one-rank NCCL mesh, its all-reduces held in the graph, the unsharded
chunk, both also at H = 512 (the grid plans of kernels 3 and 4 inside the
graphs); ``predict`` at H = 512 (kernel 2's grid plan) gives the
``"block_plain"`` decode's records. Kernel 1's bf16 form (bf16 keys;
float32 or bf16 queries, energy vector and mask) equals its plain version
on the same bf16 inputs at the float32 form's bars, and is no further from
float64 than twice the plain version. The resident graph captured under a
profiler, with device markers at its optimizer spans, gives the untraced
graph's state bit for bit; a span encloses its kernel in the CUDA trace;
the benchmark's readers of the port's spans read device time.
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


# (batch, M, H, masked): the fixture decode's two calls, W3's, H % 8 != 0
# and a row past the register-resident form.
BF16_SHAPES = {"decode_M16": (4096, 16, 100, True),
               "decode_M36": (4096, 36, 100, False),
               "W3_M72": (512, 72, 256, True),
               "W3_M144": (512, 144, 256, False),
               "H102": (256, 16, 102, True),
               "H1030": (64, 12, 1030, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("small", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(BF16_SHAPES))
def test_attention_bf16_form_matches_plain(cuda, name, small):
    """Kernel 1 on bf16 keys (queries, energy vector and mask float32 or
    bf16): float32 outputs, the plain version's on the same inputs within
    context atol 1e-5 and weights atol 1e-6, and no further from float64
    than twice the plain version (or 1e-6); a launch of the bf16 form."""
    batch, m, h, masked = BF16_SHAPES[name]
    lengths = np.random.RandomState(2).randint(0, m + 1, size=batch) \
        if masked else None
    pq, keys, mask, energy = [
        None if a is None else torch.from_numpy(a).to(cuda)
        for a in attention_inputs(4, batch, m, h, lengths)]
    keys = keys.to(torch.bfloat16)
    if small == "bf16":
        pq, energy = pq.to(torch.bfloat16), energy.to(torch.bfloat16)
        mask = None if mask is None else mask.to(torch.bfloat16)
    args = (pq, keys, mask, energy)
    before = (k1.launches, k1.launches_bf16)
    ctx, w = k1.additive_attention(*args)
    torch.cuda.synchronize()
    assert (k1.launches, k1.launches_bf16) == (before[0], before[1] + 1)
    assert ctx.dtype == w.dtype == torch.float32
    plain = k1.additive_attention_plain(*args)
    exact = k1.additive_attention_plain(*as_float64(args))
    for got, want, truth, atol in zip((ctx, w), plain, exact, (1e-5, 1e-6)):
        torch.testing.assert_close(got, want, rtol=0, atol=atol)
        kernel_err = float((got.double() - truth).abs().max())
        plain_err = float((want.double() - truth).abs().max())
        assert kernel_err <= max(2 * plain_err, 1e-6)


@pytest.mark.cuda
def test_attention_bf16_form_rejects_mixed_dtypes(cuda):
    pq, keys, mask, energy = [torch.from_numpy(a).to(cuda) for a in
                              attention_inputs(0, 4, 8, 16, [3, 8, 0, 5])]
    keys = keys.to(torch.bfloat16)
    with pytest.raises(TypeError):  # bf16 queries, float32 energy vector
        k1.additive_attention(pq.to(torch.bfloat16), keys, None, energy)
    with pytest.raises(TypeError):  # float32 queries, bf16 mask
        k1.additive_attention(pq, keys, mask.to(torch.bfloat16), energy)
    with pytest.raises(TypeError):  # bf16 queries on float32 keys
        k1.additive_attention(pq.to(torch.bfloat16), keys.float(), None,
                              energy.to(torch.bfloat16))


def block_inputs(device, batch, done_fraction, seed=5, h=100):
    """Flagship widths (M_t=16, M_v=36, H=100, V=9; or another H), random
    weights, command lengths in 1..M_t, all rows at SOS, each row done at
    entry with probability ``done_fraction``."""
    m_t, m_v, vocab = 16, 36, 9
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).to(device)

    weights = k2.DecoderWeights(
        t(h, h, scale=0.1), t(h, 1, scale=0.1), t(2 * h, h, scale=0.07),
        t(1, h, scale=0.1), t(h, h, scale=0.1), t(h, 1, scale=0.1),
        t(vocab, h), t(3 * h, 4 * h, scale=0.06), t(h, 4 * h, scale=0.1),
        t(1, 4 * h, scale=0.1), t(4 * h, h, scale=0.05),
        t(h, vocab, scale=0.3))
    weights.embedding[0] = 0.0
    lengths = torch.from_numpy(rng.randint(1, m_t + 1, size=batch)).to(device)
    mask = (torch.arange(m_t, device=device)[None] < lengths[:, None]).float()
    return (t(batch, m_t, h), mask, t(batch, m_v, h), t(batch, h, scale=0.5),
            t(batch, h, scale=0.5),
            torch.full((batch,), 1, dtype=torch.int32, device=device),
            torch.from_numpy(rng.rand(batch) < done_fraction).to(device),
            weights)


def assert_block_matches(out, ref):
    """The JAX decode test's bars: tokens, done and emitted flags equal;
    attention (and here h and c) rtol 1e-5 / atol 1e-6."""
    for name in ("tokens", "done", "step_tokens", "step_emitted"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    for name in ("step_attn_cmd", "step_attn_sit", "h", "c"):
        torch.testing.assert_close(getattr(out, name), getattr(ref, name),
                                   rtol=1e-5, atol=1e-6, msg=name)


@pytest.mark.cuda
def test_decode_block_kernel_matches_plain(cuda):
    """Flagship widths, random weights, B not a multiple of the CTA rows."""
    args = block_inputs(cuda, 1000, 0.1)
    before = k2.launches
    out = k2.fused_decode_block(*args, num_steps=12, eos_idx=2)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    ref = k2.decode_block_plain(*args, num_steps=12, eos_idx=2)
    assert_block_matches(out, ref)


def misaligned(tensor):
    """A contiguous copy of ``tensor`` 4 bytes past a 16-byte boundary."""
    storage = torch.empty(tensor.numel() + 4, dtype=tensor.dtype,
                          device=tensor.device)
    view = storage[1:1 + tensor.numel()].view(tensor.shape)
    view.copy_(tensor)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["h102", "misaligned", "h449_misaligned"])
def test_kernels_1_and_2_without_16_byte_loads(cuda, case):
    """Kernels 1 and 2 where 16-byte loads do not apply: H % 4 != 0
    (H = 102, M_t = 16, M_v = 36), or keys and weights passed 4 bytes past
    a 16-byte boundary (H = 100; and H = 449, where kernel 2 takes its grid
    plan). Kernel 1 then reads its keys a float at a time, and kernel 2
    also fills its weight ring (or its product tiles) by 4-byte copies and
    reads its tiles a column at a time. The JAX bars against the plain
    versions, and the launch counts rise; at H = 449 kernel 2 is held as in
    ``test_decode_block_past_448`` (h and c to float64, two runs bit-equal)."""
    h = {"h102": 102, "misaligned": 100, "h449_misaligned": 449}[case]
    move = misaligned if case.endswith("misaligned") else (lambda t: t)
    for m, lengths in ((16, np.random.RandomState(1).randint(
            0, 17, size=300)), (36, None)):
        pq, keys, mask, energy = [
            None if a is None else torch.from_numpy(a).to(cuda)
            for a in attention_inputs(4, 300, m, h, lengths)]
        keys = move(keys)
        before = k1.launches
        ctx, w = k1.additive_attention(pq, keys, mask, energy)
        torch.cuda.synchronize()
        assert k1.launches == before + 1
        ctx_ref, w_ref = k1.additive_attention_plain(pq, keys, mask, energy)
        torch.testing.assert_close(ctx, ctx_ref, rtol=0, atol=1e-5)
        torch.testing.assert_close(w, w_ref, rtol=0, atol=1e-6)

    args = list(block_inputs(cuda, 300, 0.5, seed=7, h=h))
    args[0], args[2] = move(args[0]), move(args[2])
    args[7] = k2.DecoderWeights(*(move(w) for w in args[7]))
    if h > 256:
        hold_wide_block(args, steps=12)
        return
    before = k2.launches
    out = k2.fused_decode_block(*args, num_steps=12, eos_idx=2)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    assert_block_matches(out, k2.decode_block_plain(*args, num_steps=12,
                                                    eos_idx=2))


@pytest.mark.cuda
@pytest.mark.parametrize("h", [1030, 2048])
def test_attention_kernel_past_register_form(cuda, h):
    """Kernel 1 past H = 1024, where a row's query and context leave the
    registers and it takes two passes over its keys: masked (lengths
    0..M, so some rows have no valid key) and unmasked, at the JAX bars."""
    for m, lengths in ((16, np.random.RandomState(2).randint(
            0, 17, size=64)), (36, None)):
        pq, keys, mask, energy = [
            None if a is None else torch.from_numpy(a).to(cuda)
            for a in attention_inputs(5, 64, m, h, lengths)]
        before = k1.launches
        ctx, w = k1.additive_attention(pq, keys, mask, energy)
        torch.cuda.synchronize()
        assert k1.launches == before + 1
        ctx_ref, w_ref = k1.additive_attention_plain(pq, keys, mask, energy)
        torch.testing.assert_close(ctx, ctx_ref, rtol=0, atol=1e-5)
        torch.testing.assert_close(w, w_ref, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_decode_block_kernel_mostly_done(cuda):
    """A block entered with 90% of the rows done, as a decode's second block
    is: the kernel meets the bars against its plain version, and each done
    row's attention rows repeat bit for bit from its first done step (the
    done-row rule: computed once, then copied), also for rows that emit EOS
    inside the block."""
    args = block_inputs(cuda, 1000, 0.9, seed=6)
    steps = 16
    before = k2.launches
    out = k2.fused_decode_block(*args, num_steps=steps, eos_idx=2)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    ref = k2.decode_block_plain(*args, num_steps=steps, eos_idx=2)
    assert_block_matches(out, ref)
    emitted = out.step_emitted.cpu().numpy()
    done_at_entry = args[6].cpu().numpy()
    finished = 0
    for row in range(emitted.shape[1]):
        count = int(emitted[:, row].sum())
        if not done_at_entry[row] and count == steps:
            continue  # still emitting at the end of the block
        finished += not done_at_entry[row]
        for attn in (out.step_attn_cmd, out.step_attn_sit):
            rows = attn[count:, row]
            assert torch.equal(rows, rows[:1].expand_as(rows)), row
    assert finished > 0  # some rows emit EOS inside the block


# Kernel 2 past its ring plans: (H = E, batch, share of rows done at entry,
# V). The ring plans take H <= 256 (their gate sums); past them the grid
# plan (6) takes every shape. H257: the first width past the ring; B1000: a
# batch that is no multiple of a tile's 128 rows; B5: fewer rows than one
# tile; mostly_done: 90% of the rows done at entry, as in a decode's second
# block; V64 and V6743: wider vocabularies (6,743: C.7's, where the logits
# product's four segments need two parts a sum); H1536, H2048: past H = 1,024,
# where an attention row's query is staged in the scratch and the gates
# need 6 and 8 parts a sum to keep each within 1,024 terms.
# The last entry is the inputs' seed.
PAST_448 = {"H257": (257, 96, 0.1, 9, 257), "W4": (449, 96, 0.1, 9, 449),
            "W5": (640, 64, 0.1, 9, 640), "W6": (1024, 64, 0.1, 9, 1024),
            "W5_B1000": (640, 1000, 0.1, 9, 1),
            "W4_B5": (449, 5, 0.1, 9, 2),
            "W5_mostly_done": (640, 1000, 0.9, 9, 3),
            "W4_V64": (449, 96, 0.1, 64, 4),
            "W4_V6743": (449, 96, 0.1, 6743, 5),
            "H1536": (1536, 64, 0.1, 9, 6), "H2048": (2048, 48, 0.1, 9, 7)}
GRID_PLAN = 6


def as_float64(args):
    """The same arguments with every float tensor in float64."""
    out = []
    for arg in args:
        if isinstance(arg, tuple):
            out.append(type(arg)(*as_float64(arg)))
        elif isinstance(arg, torch.Tensor) and arg.is_floating_point():
            out.append(arg.double())
        else:
            out.append(arg)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PAST_448) + ["decode_H640"])
def test_decode_block_past_448(cuda, name):
    """Kernel 2 past its ring plans, on the grid plan (PAST_448: H = 257,
    W4-W6: H = 449, 640 and 1024, and H = 1536 and 2048; a batch of 1000
    rows, of 5, 90% of the rows done at entry, V = 64 and 6,743): M_t = 16, M_v = 36, K = 32 steps from
    SOS, weights drawn as the JAX package initialises them; each case run
    twice, every bit the same. The JAX decode test's bars against the plain
    version: tokens, done and emitted flags equal, attention rtol 1e-5 /
    atol 1e-6. The float64 referee (PERF.md section 2) for the attention
    and the carried h and c: no further from a float64 evaluation than
    twice the plain version (or 1e-6), on the rows where float64 takes the
    same tokens. At these widths the plain version's own h and c lie about
    as far from float64 as the attention bar (c 6e-6 at H = 449), so two
    float32 evaluations may part by more than it: h and c are held to
    float64 only.
    decode_H640: a greedy decode of a model with H = 640 through
    decode_impl="block" launches kernel 2 and gives the tokens of
    "block_plain" apart from rows parting at argmax near-ties (top-2 logit
    gap below 1e-4)."""
    if name == "decode_H640":
        from multimodal_seq2seq_gscan_tpu_torch.decode.greedy import (
            make_greedy_decoder)
        from multimodal_seq2seq_gscan_tpu_torch.models.config import (
            ModelConfig)
        from multimodal_seq2seq_gscan_tpu_torch.models.params import (
            init_model_params)
        config = ModelConfig(input_vocabulary_size=12,
                             target_vocabulary_size=9, num_cnn_channels=16,
                             encoder_hidden_size=640,
                             decoder_hidden_size=640)
        params = init_model_params(config, torch.Generator().manual_seed(3),
                                   cuda)
        rng = np.random.RandomState(9)
        batch = 48
        lengths = rng.randint(3, 9, size=batch)
        ids = np.zeros((batch, 8), np.int32)
        for row, n in enumerate(lengths):
            ids[row, :n] = rng.randint(3, 12, size=n)
            ids[row, 0], ids[row, n - 1] = 1, 2
        inputs = (torch.from_numpy(ids).to(cuda),
                  torch.from_numpy(lengths.astype(np.int32)).to(cuda),
                  torch.from_numpy(rng.randint(0, 2, (batch, 6, 6, 16))
                                   .astype(np.float32)).to(cuda),
                  torch.zeros(batch, dtype=torch.int32, device=cuda))
        before = k2.launches
        out = make_greedy_decoder(config, 40, decode_impl="block")(
            params, *inputs)
        torch.cuda.synchronize()
        assert k2.launches > before
        ref = make_greedy_decoder(config, 40, decode_impl="block_plain")(
            params, *inputs)
        # Random weights give argmax near-ties: a row may part from the
        # plain decode only at a step whose top-2 logit gap there is below
        # 1e-4 (chip_smoke.py's rule); the rows that do not part agree.
        differ = (out.tokens != ref.tokens) | (out.emitted_mask
                                               != ref.emitted_mask)
        rows = differ.any(dim=1)
        for row in torch.nonzero(rows).flatten().tolist():
            step = int(torch.nonzero(differ[row]).flatten()[0])
            assert float(ref.top2_gap[row, step]) < 1e-4, (row, step)
        assert int(rows.sum()) < len(rows)
        torch.testing.assert_close(out.attention_situations[~rows],
                                   ref.attention_situations[~rows],
                                   rtol=1e-5, atol=1e-6)
        return
    h, batch, done_fraction, vocab, seed = PAST_448[name]
    plan = k2.block_plan(h, vocab, 16, 36, torch.cuda.current_device())
    assert plan.index == GRID_PLAN and plan.grid, plan
    inputs, _ = teacher_forced_inputs(cuda, batch, 1, 1, h=h, vocab=vocab,
                                      seed=seed)
    rng = np.random.RandomState(seed)
    args = (inputs[0], inputs[1], inputs[2], inputs[3], inputs[4],
            torch.ones(batch, dtype=torch.int32, device=cuda),
            torch.from_numpy(rng.rand(batch) < done_fraction).to(cuda),
            inputs[7])
    hold_wide_block(args)


def hold_wide_block(args, steps=32):
    """Kernel 2 on ``args`` (one launch of ``steps`` steps, EOS 2), run
    twice: every bit the same. Against the plain version: tokens, done and
    emitted flags equal, attention rtol 1e-5 / atol 1e-6; and the float64
    referee for the attention and the carried h and c (no further from a
    float64 evaluation than twice the plain version, or 1e-6), on the rows
    where float64 takes the same tokens."""
    before = k2.launches
    out = k2.fused_decode_block(*args, num_steps=steps, eos_idx=2)
    again = k2.fused_decode_block(*args, num_steps=steps, eos_idx=2)
    torch.cuda.synchronize()
    assert k2.launches == before + 2
    for field, first, second in zip(k2.BlockOutput._fields, out, again):
        assert torch.equal(first, second), field
    gaps = []
    ref = k2.decode_block_plain(*args, num_steps=steps, eos_idx=2,
                                top2_gap=gaps)
    for field in ("tokens", "done", "step_tokens", "step_emitted"):
        assert torch.equal(getattr(out, field), getattr(ref, field)), \
            "{} differ; the plain version's smallest top-2 logit gap " \
            "{:.3e}".format(field, float(torch.stack(gaps).min()))
    for field in ("step_attn_cmd", "step_attn_sit"):
        torch.testing.assert_close(getattr(out, field), getattr(ref, field),
                                   rtol=1e-5, atol=1e-6)
    exact = k2.decode_block_plain(*as_float64(args), num_steps=steps,
                                  eos_idx=2)
    agree = torch.nonzero((exact.step_tokens == ref.step_tokens).all(
        dim=0)).flatten()
    assert len(agree) > 0
    for field in ("step_attn_cmd", "step_attn_sit", "h", "c"):
        axis = 1 if field.startswith("step") else 0
        got, want, truth = (getattr(o, field).index_select(axis, agree)
                            for o in (out, ref, exact))
        kernel_err = float((got.double() - truth).abs().max())
        plain_err = float((want.double() - truth).abs().max())
        assert kernel_err <= max(2 * plain_err, 1e-6), (
            "{}: kernel {:.3e} and plain {:.3e} from float64, kernel {:.3e} "
            "from plain".format(field, kernel_err, plain_err,
                                float((got - want).abs().max())))


def teacher_forced_inputs(device, batch, steps, num_steps, m_t=16, m_v=36,
                          h=100, vocab=9, seed=0, e=None):
    """Flagship widths (embedding width e = h unless given); weights drawn as
    the JAX package initialises them, N(0, 1) keys, command lengths in
    1..M_t, a p=0.3 dropout mask, tokens uniform over the vocabulary with
    pad past num_steps."""
    rng = np.random.RandomState(seed)
    e = h if e is None else e

    def t(array):
        return torch.from_numpy(np.asarray(array, np.float32)).to(device)

    def uniform(shape, fan_in):
        return t(rng.uniform(-1, 1, shape) / np.sqrt(fan_in))

    embedding = rng.randn(vocab, e)
    embedding[0] = 0.0
    weights = k2.DecoderWeights(
        uniform((h, h), h), uniform((h, 1), h), uniform((2 * h, h), 2 * h),
        uniform((1, h), 2 * h), uniform((h, h), h), uniform((h, 1), h),
        t(embedding), uniform((e + 2 * h, 4 * h), h), uniform((h, 4 * h), h),
        uniform((1, 4 * h), h), uniform((e + 3 * h, h), e + 3 * h),
        uniform((h, vocab), h))
    lengths = rng.randint(1, m_t + 1, size=batch)
    mask = t(np.arange(m_t)[None] < lengths[:, None])
    tokens = rng.randint(0, vocab, size=(steps, batch))
    tokens[num_steps:] = 0
    drop = (rng.rand(steps, batch, e) > 0.3) / 0.7
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
@pytest.mark.parametrize("batch,steps,num_steps,h,e", [
    # B not a multiple of the rows per cluster
    pytest.param(203, 13, 11, 100, 100, id="203-13-11"),
    pytest.param(16, 1, 1, 100, 100, id="16-1-1"),  # T = 1
    # N = 1400 row-steps, not a multiple of the chunks
    pytest.param(200, 7, 7, 100, 100, id="200-7-7"),
    # smaller than one cluster's rows
    pytest.param(5, 3, 2, 100, 100, id="5-3-2"),
    # W3-like widths with E != H: the helper's 128 x 256 tiles with masked
    # edges (H = 320), its bias rows as one-row products, 2,639 row-steps
    pytest.param(203, 13, 11, 320, 256, id="203-13-11-H320-E256"),
    # 14,336 row-steps: more than its 12 chunks of at most 1,024, so each
    # wide chunk is summed in two runs. 12 steps of gradients, the rest
    # padding: with all 56, weight_grads_plain's own float32 sums of out_w
    # (values up to ~80) part from float64 by more than the bar allows
    # between it and the helper
    pytest.param(256, 56, 12, 320, 256, id="256-56-12-H320-E256")])
def test_kernel4_and_helper_match_plain_twins(cuda, batch, steps, num_steps,
                                              h, e):
    """Kernel 4 (one cluster per row group) against its plain twin
    ``teacher_forced_backward_plain`` and the helper (split over chunks of
    row-steps) against ``weight_grads_plain``, on the same residuals, at
    the gradient bar (rtol 2e-4 / atol 2e-5); each run twice, every bit the
    same."""
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    inputs, (dlogits, g_asum) = teacher_forced_inputs(
        cuda, batch, steps, num_steps, h=h, e=e, seed=batch + steps)
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
    # The float64 referee: the helper no further from the same sums in
    # float64 than twice the plain version (or 1e-6).
    exact = tf.weight_grads_plain(raw[4].double(), h_res.double(),
                                  dlogits.double())
    for name, got, want, truth in zip(k2.DecoderWeights._fields, grads,
                                      plain_grads, exact):
        kernel_err = float((got.double() - truth).abs().max())
        plain_err = float((want.double() - truth).abs().max())
        assert kernel_err <= max(2 * plain_err, 1e-6), (name, kernel_err,
                                                         plain_err)
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


# Kernels 3 and 4 past their resident cluster plans: (batch, T, num_steps,
# M_t, M_v, H, E, the plans (kernel 3, kernel 4): "resident", a cluster
# plan with the weights in shared memory; "L2", one that reads them from
# L2, which only narrow widths and few keys take (kernel 3: H <= 320 and H
# (M_t + M_v) <= 18,432; kernel 4: H <= 192), where it measured faster;
# "grid", the grid plan). H116 and H136: past the
# resident plans, the L2 plans; W3 (M_t = 72, M_v = 144): the grid plans,
# where the L2 plans ran before; 449 with E = 256: H % 4 != 0 (4-byte
# weight copies and key loads) and E != H; 512 and past: widths no cluster
# plan fits (C.12); B200_T56: the training shape at H = 512, the logits'
# cotangent on its first GRAD_STEPS steps (on all 53, out_proj's gradient
# sums 10,600 row-steps, and the kernel and the plain version, each ~7e-5
# from float64, part by more than the gradient bar: a float32 sum that long
# holds neither), then on all of them held to float64 alone; B5: fewer rows
# than a tile. The inputs' seed is the batch plus H.
GRID_TEACHER_FORCED = {
    "H116": (37, 6, 5, 16, 36, 116, 116, ("L2", "L2")),
    "H136": (37, 6, 5, 16, 36, 136, 136, ("L2", "L2")),
    "W3": (37, 6, 5, 72, 144, 256, 256, ("grid", "grid")),
    "H449_E256": (37, 6, 5, 16, 36, 449, 256, ("grid", "grid")),
    "H512": (37, 6, 5, 16, 36, 512, 512, ("grid", "grid")),
    "H640": (24, 5, 4, 16, 36, 640, 640, ("grid", "grid")),
    "H1024": (16, 4, 4, 16, 36, 1024, 1024, ("grid", "grid")),
    "H1536": (9, 3, 3, 16, 36, 1536, 1536, ("grid", "grid")),
    "B200_T56": (200, 56, 53, 16, 36, 512, 512, ("grid", "grid")),
    "B5": (5, 6, 5, 16, 36, 640, 640, ("grid", "grid")),
}
GRAD_STEPS = {"B200_T56": 12}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRID_TEACHER_FORCED))
def test_teacher_forced_grid_plans(cuda, name):
    """Kernels 3 and 4 and the helper past their resident plans: the plan
    each kernel takes; against the plain unroll and its autograd
    gradients at the JAX bars (logits rtol/atol 1e-5, summed attention rtol
    1e-5 / atol 1e-6, gradients rtol 2e-4 / atol 2e-5), kernel 4 against its
    plain twin (the stash too) at the gradient bar, and every output no
    further from a float64 evaluation than twice the plain version (or
    1e-6); each run twice, every bit the same. Where GRAD_STEPS scores only
    the first steps, the whole walk's gradients are held to float64 as
    well."""
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    batch, steps, num_steps, m_t, m_v, h, e, plans = \
        GRID_TEACHER_FORCED[name]
    inputs, (dlogits, g_asum) = teacher_forced_inputs(
        cuda, batch, steps, num_steps, m_t=m_t, m_v=m_v, h=h, e=e,
        seed=batch + h)
    whole_walk = dlogits.clone()
    dlogits[GRAD_STEPS.get(name, num_steps):] = 0.0
    for kernel, want in zip(("teacher_forced_forward",
                             "teacher_forced_backward"), plans):
        _, plan_name, _ = tf.shared_memory_plan(
            kernel, m_t, m_v, h, e, 9, torch.cuda.current_device())
        kind = ("grid" if plan_name.startswith("grid") else "L2"
                if plan_name.startswith(("weights from L2",
                                         "weights+keys from L2"))
                else "resident")
        assert kind == want, (kernel, plan_name)
    before = dict(tf.launches)
    logits, h_res, c_res, asum = tf.teacher_forced_forward(
        *inputs, num_steps=num_steps)
    raw, grads, _ = kernel4_and_helper(inputs, dlogits, g_asum, num_steps)
    for kernel, count in tf.launches.items():
        assert count == before[kernel] + (2 if kernel
                                          == "teacher_forced_forward" else 1)

    def plain(args, cotangents):
        leaves = [x.clone().requires_grad_(True) for x in
                  (args[0], args[2], args[3], args[4], *args[7])]
        out = tf.teacher_forced_plain(
            leaves[0], args[1], leaves[1], leaves[2], leaves[3], args[5],
            args[6], k2.DecoderWeights(*leaves[4:]), num_steps=num_steps)
        grads = torch.autograd.grad(
            (out[0] * cotangents[0]).sum() + (out[1] * cotangents[1]).sum(),
            leaves)
        return [out[0][:num_steps].detach(), out[1].detach()] + list(grads)

    got = [logits[:num_steps], asum] + raw[:4] + grads
    want = plain(inputs, (dlogits, g_asum))
    exact = plain(as_float64(inputs), as_float64((dlogits, g_asum)))
    names = ["logits", "asum", "proj_txt", "proj_vis", "h0", "c0"] + list(
        k2.DecoderWeights._fields)
    bars = [(1e-5, 1e-5), (1e-5, 1e-6)] + [(2e-4, 2e-5)] * 16
    for field, a, b, x, (rtol, atol) in zip(names, got, want, exact, bars):
        kernel_err = float((a.double() - x).abs().max())
        plain_err = float((b.double() - x).abs().max())
        torch.testing.assert_close(
            a, b, rtol=rtol, atol=atol, msg="{}: max |err| {:.3e} against "
            "the plain version; vs float64: kernel {:.3e}, plain {:.3e}".format(
                field, float((a - b).abs().max()), kernel_err, plain_err))
        assert kernel_err <= max(2 * plain_err, 1e-6), (field, kernel_err,
                                                         plain_err)
    twin = tf.teacher_forced_backward_plain(
        inputs[0], inputs[1], inputs[2], inputs[5], inputs[6], inputs[7],
        h_res, c_res, dlogits, g_asum, num_steps=num_steps)
    for field, a, b in zip(["d_proj_txt", "d_proj_vis", "dh0", "dc0",
                            "stash"], raw, twin):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5, msg=field)
    forward_again = tf.teacher_forced_forward(*inputs, num_steps=num_steps)
    raw_again, grads_again, _ = kernel4_and_helper(inputs, dlogits, g_asum,
                                                   num_steps)
    for first, second in zip([logits, h_res, c_res, asum] + raw + grads,
                             list(forward_again) + raw_again + grads_again):
        assert torch.equal(first, second)
    if name in GRAD_STEPS:
        # The whole walk, every step's cotangent: each gradient no further
        # from float64 than twice the plain version (the kernel and the
        # plain version part by more than the gradient bar here).
        raw, grads, _ = kernel4_and_helper(inputs, whole_walk, g_asum,
                                           num_steps)
        want = plain(inputs, (whole_walk, g_asum))
        exact = plain(as_float64(inputs), as_float64((whole_walk, g_asum)))
        for field, a, b, x in zip(names[2:], raw[:4] + grads, want[2:],
                                  exact[2:]):
            kernel_err = float((a.double() - x).abs().max())
            plain_err = float((b.double() - x).abs().max())
            assert kernel_err <= max(2 * plain_err, 1e-6), (
                "whole walk", field, kernel_err, plain_err)


def resident_toy(device, n=48, grid=4, channels=6, t_in=7, t_out=12):
    """A toy training split on the card (the JAX resident tests' layout):
    uint8 grids, int32 ids, lengths 3..t_out."""
    from multimodal_seq2seq_gscan_tpu_torch.train.resident import (
        ResidentData)
    rng = np.random.RandomState(0)
    input_lengths = rng.randint(3, t_in + 1, size=n).astype(np.int32)
    target_lengths = rng.randint(3, t_out + 1, size=n).astype(np.int32)
    input_ids = np.zeros((n, t_in), np.int32)
    target_ids = np.zeros((n, t_out), np.int32)
    for i in range(n):
        input_ids[i, :input_lengths[i]] = rng.randint(
            3, 12, size=input_lengths[i])
        target_ids[i, :target_lengths[i]] = rng.randint(
            3, 8, size=target_lengths[i])
    return ResidentData(*(torch.from_numpy(a).to(device) for a in (
        input_ids, input_lengths,
        (rng.rand(n, grid, grid, channels) < 0.2).astype(np.uint8),
        target_ids, target_lengths,
        rng.randint(0, grid * grid, size=n).astype(np.int32),
        rng.randint(0, grid * grid, size=n).astype(np.int32))))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["full", "stratified"])
def test_resident_graph_equals_eager_steps(cuda, layout):
    """The resident trainer's CUDA graph of a K = 6 chunk against 6 eager
    train_step calls on the same index rows, dropout on, kernels 3 and 4
    in the step: losses and metrics rtol 2e-5 / atol 1e-6, params and Adam
    moments atol 1e-6 (JAX's chunk test's bars); a second chunk from the
    first one's state too (the graph replayed with the next steps' dropout
    seeds). The stratified layout narrows the targets of its segments
    (here widths 8 and 12)."""
    from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
    from multimodal_seq2seq_gscan_tpu_torch.models.params import leaves
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    from multimodal_seq2seq_gscan_tpu_torch.train import resident
    from multimodal_seq2seq_gscan_tpu_torch.train.state import (
        Adam, create_train_state)
    from multimodal_seq2seq_gscan_tpu_torch.train.step import train_step
    config = ModelConfig(input_vocabulary_size=12, target_vocabulary_size=8,
                         num_cnn_channels=6, embedding_dimension=10,
                         encoder_hidden_size=12, decoder_hidden_size=12,
                         cnn_kernel_size=3, cnn_hidden_num_channels=6,
                         auxiliary_task=True)
    optimizer = Adam()
    data = resident_toy(cuda)
    k, batch = 6, 8
    if layout == "full":
        blocks = ((b, None) for b in resident.index_block_stream(
            data.num_examples, batch, k, np.random.default_rng(3)))
    else:
        blocks = resident.stratified_index_block_stream(
            data.target_lengths.cpu().numpy(), batch, k,
            np.random.default_rng(3), cuts=(8,))
    state = create_train_state(5, config, optimizer, device=cuda)
    chunk = resident.make_train_chunk(config, optimizer)
    eager, graphed = state, state
    before = dict(tf.launches)
    for _ in range(2):
        block, segments = next(blocks)
        graphed, metrics = chunk(graphed, data, block, segments)
        widths = [w for count, w in (segments or ((k, 12),))
                  for _ in range(count)]
        for j, (row, width) in enumerate(zip(block, widths)):
            b = resident.gather_batch(data, row)
            b = b._replace(target_ids=b.target_ids[:, :width])
            eager, step_metrics = train_step(eager, b, config, optimizer)
            for name, value in step_metrics.items():
                torch.testing.assert_close(metrics[name][j], value,
                                           rtol=2e-5, atol=1e-6, msg=name)
        assert graphed.step == eager.step
        assert graphed.opt_state[0::3] == eager.opt_state[0::3]
        for tree in ("params", "mu", "nu"):
            get = (lambda s: s.params) if tree == "params" else (
                lambda s, t=tree: getattr(s.opt_state, t))
            for a, b in zip(leaves(get(graphed)), leaves(get(eager))):
                torch.testing.assert_close(a, b, rtol=0, atol=1e-6,
                                           msg=tree)
    for kernel, count in tf.launches.items():
        assert count > before[kernel], kernel


@pytest.mark.cuda
def test_two_layer_graph_equals_eager_steps(cuda):
    """A decoder of two layers (inter-layer dropout in the encoder and the
    decoder, the step unroll whose attentions are kernel 1 with its plain
    backward) in the resident trainer's CUDA graph of a K = 4 chunk: the
    eager steps' metrics (rtol 2e-5 / atol 1e-6), params and Adam moments
    (atol 1e-6); kernel 1 launched while the chunk is captured."""
    from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
    from multimodal_seq2seq_gscan_tpu_torch.models.params import leaves
    from multimodal_seq2seq_gscan_tpu_torch.train import resident
    from multimodal_seq2seq_gscan_tpu_torch.train.state import (
        Adam, create_train_state)
    from multimodal_seq2seq_gscan_tpu_torch.train.step import train_step
    config = ModelConfig(input_vocabulary_size=12, target_vocabulary_size=8,
                         num_cnn_channels=6, embedding_dimension=10,
                         encoder_hidden_size=12, decoder_hidden_size=12,
                         num_encoder_layers=2, num_decoder_layers=2,
                         cnn_kernel_size=3, cnn_hidden_num_channels=6)
    optimizer = Adam()
    data = resident_toy(cuda)
    k, batch = 4, 8
    block = next(resident.index_block_stream(
        data.num_examples, batch, k, np.random.default_rng(3)))
    state = create_train_state(5, config, optimizer, device=cuda)
    before = k1.launches
    graphed, metrics = resident.make_train_chunk(config, optimizer)(
        state, data, block)
    assert k1.launches > before
    eager = state
    for j, row in enumerate(block):
        eager, step_metrics = train_step(
            eager, resident.gather_batch(data, row), config, optimizer)
        for name, value in step_metrics.items():
            torch.testing.assert_close(metrics[name][j], value, rtol=2e-5,
                                       atol=1e-6, msg=name)
    for tree in ("params", "mu", "nu"):
        get = (lambda s: s.params) if tree == "params" else (
            lambda s, t=tree: getattr(s.opt_state, t))
        for a, b in zip(leaves(get(graphed)), leaves(get(eager))):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=tree)


def toy_config(h, **options):
    """The resident toy's model: decoder width h (12, or 512, where kernels
    3 and 4 take their grid plans, checked here)."""
    from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    config = ModelConfig(input_vocabulary_size=12, target_vocabulary_size=8,
                         num_cnn_channels=6, embedding_dimension=10,
                         encoder_hidden_size=h, decoder_hidden_size=h,
                         cnn_kernel_size=3, cnn_hidden_num_channels=6,
                         **options)
    if h >= 512:
        for kernel in tf.KERNEL_NUMBERS:
            _, plan, _ = tf.shared_memory_plan(
                kernel, 7, 16, h, config.embedding_dimension, 8,
                torch.cuda.current_device())
            assert plan.startswith("grid"), (kernel, plan)
    return config


@pytest.mark.cuda
@pytest.mark.parametrize("h", [12, 512])
def test_multiseed_graph_equals_single_seed_graphs(cuda, h):
    """The multi-seed chunk's one CUDA graph (two seeds' K = 4 steps in
    turn, dropout on) against each seed's single-seed graphed chunk: params,
    moments and metrics bit for bit (the training step takes cuDNN's
    deterministic algorithms), also at H = 512, where the graph holds each
    seed's cooperative launches of kernels 3 and 4's grid plans; and a
    dropped chunk maker's graphs are freed by reference counting, not left
    to the cycle collector (which could destroy them during another capture
    and invalidate it)."""
    import gc
    import weakref
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    from multimodal_seq2seq_gscan_tpu_torch.train import multiseed, resident
    from multimodal_seq2seq_gscan_tpu_torch.train.state import (
        Adam, create_train_state)
    config = toy_config(h)
    optimizer = Adam()
    data = resident_toy(cuda)
    before = dict(tf.launches)
    states = [create_train_state(s, config, optimizer, device=cuda)
              for s in (7, 8)]
    blocks = np.stack([next(resident.index_block_stream(
        data.num_examples, 8, 4, np.random.default_rng(s))) for s in (7, 8)])
    stacked, metrics = multiseed.make_multiseed_train_chunk(
        config, optimizer)(multiseed.stack_train_states(states), data,
                           blocks)
    for i, (state, block) in enumerate(zip(states, blocks)):
        single, single_metrics = resident.make_train_chunk(
            config, optimizer)(state, data, block)
        got = multiseed.slice_train_state(stacked, i)
        for name in resident.METRIC_NAMES:
            assert torch.equal(metrics[name][i], single_metrics[name]), name
        for tree in ("params", "mu", "nu"):
            get = (lambda s: s.params) if tree == "params" else (
                lambda s, t=tree: getattr(s.opt_state, t))
            assert leaves_equal(get(got), get(single)), tree
    for kernel, count in tf.launches.items():
        assert count > before[kernel], kernel
    graphs = resident.ChunkGraphs(config, optimizer, 0.3)
    graphs.replay([states[0]], data, blocks[:1])
    ref = weakref.ref(graphs)
    gc.disable()
    try:
        del graphs
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.cuda
@pytest.mark.parametrize("h", [12, 512])
def test_nccl_one_rank_chunk_graph_equals_unsharded(cuda, tmp_path, h):
    """The resident chunk under a one-rank NCCL mesh, its CUDA graph
    holding the step's all-reduces, against the unsharded graphed chunk:
    params, moments and metrics bit for bit over two chunks (full layout,
    dropout and the auxiliary task on), also at H = 512 (kernels 3 and 4's
    grid plans beside the all-reduces), and one graph a chunk maker."""
    import torch.distributed as dist
    from multimodal_seq2seq_gscan_tpu_torch.parallel.mesh import make_mesh
    from multimodal_seq2seq_gscan_tpu_torch.train import resident
    from multimodal_seq2seq_gscan_tpu_torch.train.state import (
        Adam, create_train_state)
    config = toy_config(h, auxiliary_task=True)
    optimizer = Adam()
    data = resident_toy(cuda)
    blocks = resident.index_block_stream(data.num_examples, 8, 4,
                                         np.random.default_rng(3))
    dist.init_process_group("nccl", init_method="file://{}".format(
        tmp_path / "store"), world_size=1, rank=0)
    try:
        mesh = make_mesh()
        assert mesh.backend == "nccl" and mesh.shape == (1, 1)
        sharded = resident.make_train_chunk(config, optimizer, mesh=mesh)
        plain = resident.make_train_chunk(config, optimizer)
        a = b = create_train_state(5, config, optimizer, device=cuda)
        for _ in range(2):
            block = next(blocks)
            a, a_metrics = sharded(a, data, block)
            b, b_metrics = plain(b, data, block)
            for name in resident.METRIC_NAMES:
                assert torch.equal(a_metrics[name], b_metrics[name]), name
            assert leaves_equal(a.params, b.params)
            assert leaves_equal(a.opt_state.mu, b.opt_state.mu)
            assert leaves_equal(a.opt_state.nu, b.opt_state.nu)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_predict_at_h512_equals_block_plain(cuda, monkeypatch):
    """``predict`` of 64 fixture dev examples with a decoder of H = E = 512
    (random weights from seed 42), kernel 2 on its grid plan, against the
    same records through ``"block_plain"``: every output token equal, the
    attention rows at the decode block's bars (rtol 1e-5 / atol 1e-6)."""
    import os
    from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
        GroundedScanDataset)
    from multimodal_seq2seq_gscan_tpu_torch.decode import greedy
    from multimodal_seq2seq_gscan_tpu_torch.decode.predict import predict
    from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
    from multimodal_seq2seq_gscan_tpu_torch.train.state import (
        Adam, create_train_state)
    fixture = os.path.join(os.path.dirname(__file__), "..", "data",
                           "bench_fixture")
    dataset = GroundedScanDataset(os.path.join(fixture, "dataset.txt"),
                                  fixture, split="dev")
    dataset.read_dataset(max_examples=64)
    config = ModelConfig(
        input_vocabulary_size=dataset.input_vocabulary_size,
        target_vocabulary_size=dataset.target_vocabulary_size,
        num_cnn_channels=dataset.image_channels, encoder_hidden_size=512,
        decoder_hidden_size=512)
    plan = k2.block_plan(512, dataset.target_vocabulary_size, 16, 36,
                         torch.cuda.current_device())
    assert plan.grid, plan.describe()
    params = create_train_state(42, config, Adam(), device=cuda).params
    before = k2.launches
    got = list(predict(dataset, params, config, 120, batch_size=64,
                       device=cuda))
    assert k2.launches > before
    monkeypatch.setattr(greedy, "DEFAULT_DECODE_IMPL", "block_plain")
    before = k2.launches
    want = list(predict(dataset, params, config, 120, batch_size=64,
                        device=cuda))
    assert k2.launches == before
    assert len(got) == len(want) == 64
    for a, b in zip(got, want):
        assert a["output_ids"] == b["output_ids"]
        for key in ("attention_weights_input", "attention_weights_situation"):
            torch.testing.assert_close(
                torch.tensor(a[key], dtype=torch.float64),
                torch.tensor(b[key], dtype=torch.float64), rtol=1e-5,
                atol=1e-6, msg=key)


def leaves_equal(a, b):
    from multimodal_seq2seq_gscan_tpu_torch.models.params import leaves
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def profiled():
    """A torch.profiler of the host and the card: the port's spans are
    on inside it (``utils/profiling.py``)."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@pytest.mark.cuda
def test_marked_chunk_graph_equals_unmarked(cuda):
    """Two K = 4 chunks through the graph captured under a profiler, which
    holds the device markers of every step's ``gscan.step.optimizer``
    spans, against the same chunks through the untraced graph: params,
    moments and metrics bit for bit. Each traced call records one
    ``gscan.chunk`` root of 4 steps; the first captures
    (``gscan.chunk.capture``), the second does not; the markers of each
    replay (two a step: Adam and the write of the state) read above 0
    device ms. Each call's host work is split among its children: the
    bind copies, the scalars and seeds, the uploads and the launch, once
    each and inside the root."""
    from multimodal_seq2seq_gscan_tpu_torch.train import resident
    from multimodal_seq2seq_gscan_tpu_torch.train.state import (
        Adam, create_train_state)
    from multimodal_seq2seq_gscan_tpu_torch.utils import profiling
    config = toy_config(12, auxiliary_task=True)
    optimizer = Adam()
    data = resident_toy(cuda)
    blocks = resident.index_block_stream(data.num_examples, 8, 4,
                                         np.random.default_rng(3))
    plain = resident.make_train_chunk(config, optimizer)
    marked = resident.make_train_chunk(config, optimizer)
    a = b = create_train_state(5, config, optimizer, device=cuda)
    for call in range(2):
        block = next(blocks)
        a, a_metrics = plain(a, data, block)
        profiling.recorder.clear()
        with profiled():
            b, b_metrics = marked(b, data, block)
            torch.cuda.synchronize()
        for name in resident.METRIC_NAMES:
            assert torch.equal(a_metrics[name], b_metrics[name]), name
        assert leaves_equal(a.params, b.params)
        assert leaves_equal(a.opt_state.mu, b.opt_state.mu)
        assert leaves_equal(a.opt_state.nu, b.opt_state.nu)
        spans = profiling.recorder.spans()
        (root,) = [s for s in spans if s.parent is None]
        assert root.name == "gscan.chunk" and root.counts == {"steps": 4}
        kids = [s for s in spans if s.parent == root.id]
        captures = [s for s in kids if s.name == "gscan.chunk.capture"]
        assert len(captures) == (1 if call == 0 else 0)
        markers = [s for s in kids if s.name == "gscan.step.optimizer"]
        assert len(markers) == 2 * 4
        assert all(s.device_ms() > 0 for s in markers)
        phases = [s for s in kids if s.name not in (
            "gscan.chunk.capture", "gscan.step.optimizer")]
        assert [s.name for s in phases] == [
            "gscan.chunk.bind", "gscan.chunk.scalars", "gscan.chunk.upload",
            "gscan.chunk.launch"]
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
                   for s in phases)


@pytest.mark.cuda
def test_span_encloses_its_kernel_in_the_trace(cuda):
    """A span around one kernel's launch and a synchronise: the kernel's
    device interval in the CUDA trace lies inside the span's host interval
    (one clock), and the span's device events read above 0 ms."""
    from multimodal_seq2seq_gscan_tpu_torch.utils import profiling
    x = torch.ones(1 << 22, device=cuda)
    torch.cuda.synchronize()
    with profiled() as prof:
        with profiling.span("gscan.test", timed=True) as record:
            y = x * 3
            torch.cuda.synchronize()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and "elementwise" in e.name()]
    assert len(kernels) == 1
    start = kernels[0].start_ns()
    assert record.start_ns <= start
    assert start + kernels[0].duration_ns() <= record.end_ns
    assert record.device_ms() > 0
    assert float(y[0]) == 3.0


@pytest.mark.cuda
def test_span_readers_read_device_time(cuda):
    """The benchmark's readers of the port's spans over a traced window of
    one decode (kernel 2) and one graphed chunk, after a unit of each
    before the window: ``decode_encoder_ms`` and
    ``optimizer_ms_per_step`` above 0, at least two host syncs a decode,
    and a chunk's enqueue above 0 ms."""
    from benchmark.harness.core import Context, _reader
    from benchmark.harness.trace import Tracer
    from multimodal_seq2seq_gscan_tpu_torch.decode.greedy import (
        make_greedy_decoder)
    from multimodal_seq2seq_gscan_tpu_torch.train import resident
    from multimodal_seq2seq_gscan_tpu_torch.train.state import (
        Adam, create_train_state)
    config = toy_config(12)
    optimizer = Adam()
    data = resident_toy(cuda)
    state = create_train_state(5, config, optimizer, device=cuda)
    decode = make_greedy_decoder(config, 20, exit_check_every=8)
    chunk = resident.make_train_chunk(config, optimizer)
    blocks = resident.index_block_stream(data.num_examples, 8, 4,
                                         np.random.default_rng(3))
    state, _ = chunk(state, data, next(blocks))  # the untraced graph

    def unit():
        nonlocal state
        decode(state.params, data.input_ids, data.input_lengths,
               data.situations.float(), data.target_positions)
        state, _ = chunk(state, data, next(blocks))

    tracer = Tracer(True)
    tracer.start()
    unit()
    torch.cuda.synchronize()
    with tracer.span("window"):
        unit()
        torch.cuda.synchronize()
    tracer.stop()
    ctx = Context(tracer.trace, {"kind": "decode", "batches": 1}, {})
    assert _reader("decode_encoder_ms")(ctx) > 0
    assert _reader("host_syncs_per_batch.decode")(ctx) >= 2
    assert _reader("device_idle.decode_encoder")(ctx) is not None
    ctx = ctx._replace(counts={"kind": "train", "steps": 4})
    assert _reader("optimizer_ms_per_step")(ctx) > 0
    assert _reader("chunk_enqueue_ms")(ctx) > 0


@pytest.mark.cuda
def test_profile_dir_traces_steady_chunks(cuda, tmp_path):
    """``train(profile_dir=)`` with K = 10 on the card: the trace holds a
    replayed chunk (``gscan.chunk``, its ``gscan.chunk.launch``) and no
    capture, since the marked graph is captured in the warm-up chunk whose
    trace is dropped."""
    import json
    import os
    from multimodal_seq2seq_gscan_tpu_torch.train.loop import train
    fixture = os.path.join(os.path.dirname(__file__), "..", "data",
                           "bench_fixture")
    trace_dir = tmp_path / "trace"
    state, _ = train(os.path.join(fixture, "dataset.txt"), fixture,
                     output_directory=str(tmp_path / "out"), device=cuda,
                     max_training_examples=16, training_batch_size=4,
                     embedding_dimension=8, encoder_hidden_size=12,
                     decoder_hidden_size=12, cnn_kernel_size=3,
                     cnn_hidden_num_channels=6, print_every=10,
                     evaluate_every=1000, max_training_iterations=40,
                     steps_per_execution=10, profile_dir=str(trace_dir))
    assert state.step == 40
    (trace,) = trace_dir.glob("*.pt.trace.json")
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"gscan.chunk", "gscan.chunk.launch"} <= names
    assert "gscan.chunk.capture" not in names
