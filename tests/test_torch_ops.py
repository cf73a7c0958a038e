"""The port's kernels, as their plain PyTorch versions, equal the JAX Pallas
kernels (run in interpret mode on the CPU); on a card, each CUDA kernel
equals its plain version.

Bars are those of the JAX package's own kernel tests: attention context
atol 1e-5 and weights atol 1e-6 (tests/test_pallas_attention.py); decode
block tokens, done and emitted flags equal, attention rtol 1e-5 / atol 1e-6
(tests/test_pallas_decoder.py). The CUDA kernels themselves are held
against these plain versions on the card by tests/test_torch_kernels.py.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_seq2seq_gscan_tpu.models import ModelConfig as JaxConfig
from multimodal_seq2seq_gscan_tpu.models import init_model_params
from multimodal_seq2seq_gscan_tpu.models import model as jax_model
from multimodal_seq2seq_gscan_tpu.ops import pallas_decoder
from multimodal_seq2seq_gscan_tpu.ops.pallas_attention import (
    fused_additive_attention)
from multimodal_seq2seq_gscan_tpu_torch.models.params import (
    params_from_numpy)
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


@pytest.mark.parametrize("masked", [True, False])
def test_attention_plain_matches_pallas(masked):
    batch, m, h = 9, 17, 16
    # Row 6 is all-masked: the -1e9 fill gives it uniform weights.
    lengths = [m, 3, 5, m, 1, 8, 0, 2, 9] if masked else None
    pq, keys, mask, energy = attention_inputs(0, batch, m, h, lengths)
    jmask = mask if masked else np.ones((batch, m), np.float32)
    ctx_ref, w_ref = fused_additive_attention(
        jnp.asarray(pq), jnp.asarray(keys), jnp.asarray(jmask),
        jnp.asarray(energy), interpret=True)
    before = k1.launches
    ctx, w = k1.additive_attention(
        torch.from_numpy(pq), torch.from_numpy(keys),
        None if mask is None else torch.from_numpy(mask),
        torch.from_numpy(energy))
    assert k1.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_ref), atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=1e-6)
    if masked:
        assert float(w[1, 3:].abs().max()) == 0.0
        np.testing.assert_allclose(w[6].numpy(), np.full(m, 1.0 / m),
                                   atol=1e-6)


@pytest.fixture(scope="module")
def decoder_setup():
    """H=12 model of tests/test_pallas_decoder.py, encoded by JAX."""
    config = JaxConfig(input_vocabulary_size=12, target_vocabulary_size=9,
                       num_cnn_channels=8, embedding_dimension=8,
                       encoder_hidden_size=12, decoder_hidden_size=12,
                       cnn_kernel_size=3, cnn_hidden_num_channels=6)
    params = init_model_params(jax.random.PRNGKey(2), config)
    rng = np.random.RandomState(0)
    batch, t_in = 7, 8
    lengths = rng.randint(3, t_in + 1, size=batch).astype(np.int32)
    ids = np.zeros((batch, t_in), np.int32)
    for i in range(batch):
        ids[i, 0] = 1
        ids[i, 1:lengths[i] - 1] = rng.randint(3, 12, size=lengths[i] - 2)
        ids[i, lengths[i] - 1] = 2
    situations = rng.rand(batch, 5, 5, 8).astype(np.float32)
    encoded = jax_model.encode_input(params, config, jnp.asarray(ids),
                                     jnp.asarray(lengths),
                                     jnp.asarray(situations))
    proj_txt, proj_vis = jax_model.project_keys(params, encoded)
    hidden = jax_model.initialize_decoder_hidden(params, config,
                                                 encoded.hidden)
    tree = jax.tree.map(np.asarray, flax.serialization.to_state_dict(params))
    return (config, params, params_from_numpy(tree, device="cpu"),
            np.array(proj_txt), np.array(encoded.command_mask),
            np.array(proj_vis), np.array(hidden[0][0]),
            np.array(hidden[1][0]))


def test_pack_decoder_weights_matches_jax(decoder_setup):
    config, jparams, tparams = decoder_setup[:3]
    ref = pallas_decoder.pack_decoder_weights(jparams, config.target_pad_idx)
    port = k2.pack_decoder_weights(tparams, config.target_pad_idx)
    assert len(port) == len(ref) == 12
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    assert float(port.embedding[config.target_pad_idx].abs().max()) == 0.0


def test_decode_block_plain_matches_pallas(decoder_setup):
    """Two chained 8-step blocks from SOS, as the greedy loop runs them."""
    config, jparams, tparams, txt, mask, vis, h, c = decoder_setup
    batch = txt.shape[0]
    jweights = pallas_decoder.pack_decoder_weights(jparams,
                                                   config.target_pad_idx)
    tweights = k2.pack_decoder_weights(tparams, config.target_pad_idx)
    jstate = (jnp.asarray(h), jnp.asarray(c),
              jnp.full((batch,), 1, jnp.int32), jnp.zeros((batch,), bool))
    tstate = (torch.from_numpy(h), torch.from_numpy(c),
              torch.full((batch,), 1, dtype=torch.int32),
              torch.zeros((batch,), dtype=torch.bool))
    before = k2.launches
    for _ in range(2):
        ref = pallas_decoder.fused_decode_block(
            jnp.asarray(txt), jnp.asarray(mask), jnp.asarray(vis), *jstate,
            jweights, num_steps=8, sos_idx=1, eos_idx=2, interpret=True)
        out = k2.fused_decode_block(
            torch.from_numpy(txt), torch.from_numpy(mask),
            torch.from_numpy(vis), *tstate, tweights, num_steps=8, eos_idx=2)
        (rh, rc, rtok, rdone, rstep_tok, remitted, rattn_cmd,
         rattn_sit) = [np.asarray(x) for x in ref]
        np.testing.assert_array_equal(out.tokens.numpy(), rtok)
        np.testing.assert_array_equal(out.done.numpy(), rdone)
        np.testing.assert_array_equal(out.step_tokens.numpy(), rstep_tok)
        np.testing.assert_array_equal(out.step_emitted.numpy(), remitted)
        np.testing.assert_allclose(out.step_attn_cmd.numpy(), rattn_cmd,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out.step_attn_sit.numpy(), rattn_sit,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out.h.numpy(), rh, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out.c.numpy(), rc, rtol=1e-5, atol=1e-6)
        jstate = ref[:4]
        tstate = out[:4]
    assert k2.launches == before  # CPU tensors take the plain version


def first_done_steps(done_at_entry, step_emitted):
    """Per row, the first step (over the concatenated blocks) at which it is
    done: 0 if done at entry, else the step after its last emitting one, or
    None if it never finishes."""
    steps = []
    for row in range(step_emitted.shape[1]):
        emitted = np.nonzero(step_emitted[:, row])[0]
        if done_at_entry[row]:
            steps.append(0)
        elif len(emitted) < step_emitted.shape[0]:
            steps.append(int(emitted[-1]) + 1 if len(emitted) else 0)
        else:
            steps.append(None)
    return steps


@pytest.mark.parametrize("eos_idx", [2, 5])
def test_decode_block_done_rows_repeat_their_attention(decoder_setup,
                                                       eos_idx):
    """The done-row rule, on JAX's kernel and the port's plain version: two
    chained 8-step blocks with rows 3 and 6 done at entry and row 0 emitting
    EOS inside the first block (step 2 for EOS 2, step 1 for EOS 5; with
    EOS 2 the other rows finish at step 0, with EOS 5 they never do). The
    two agree at the JAX bars, and in both each done row's attention rows
    are bit-identical from its first done step on, across the block
    boundary too: the rows the CUDA kernel computes once and copies."""
    config, jparams, tparams, txt, mask, vis, h, c = decoder_setup
    batch = txt.shape[0]
    done0 = np.zeros(batch, bool)
    done0[[3, 6]] = True
    jweights = pallas_decoder.pack_decoder_weights(jparams,
                                                   config.target_pad_idx)
    tweights = k2.pack_decoder_weights(tparams, config.target_pad_idx)
    jstate = (jnp.asarray(h), jnp.asarray(c),
              jnp.full((batch,), 1, jnp.int32), jnp.asarray(done0))
    tstate = (torch.from_numpy(h), torch.from_numpy(c),
              torch.full((batch,), 1, dtype=torch.int32),
              torch.from_numpy(done0))
    jblocks, tblocks = [], []
    for _ in range(2):
        ref = pallas_decoder.fused_decode_block(
            jnp.asarray(txt), jnp.asarray(mask), jnp.asarray(vis), *jstate,
            jweights, num_steps=8, sos_idx=1, eos_idx=eos_idx,
            interpret=True)
        out = k2.fused_decode_block(
            torch.from_numpy(txt), torch.from_numpy(mask),
            torch.from_numpy(vis), *tstate, tweights, num_steps=8,
            eos_idx=eos_idx)
        jblocks.append([np.asarray(x) for x in ref])
        tblocks.append([x.numpy() for x in out])
        jstate, tstate = ref[:4], out[:4]
    for index, name in enumerate(k2.BlockOutput._fields):
        for got, want in zip([b[index] for b in tblocks],
                             [b[index] for b in jblocks]):
            if name in ("tokens", "done", "step_tokens", "step_emitted"):
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                           err_msg=name)

    emitted = np.concatenate([b[5] for b in jblocks])
    first_done = first_done_steps(done0, emitted)
    assert first_done[3] == first_done[6] == 0
    assert first_done[0] == {2: 3, 5: 2}[eos_idx]  # EOS inside block 1
    # With EOS 5 the rows that keep emitting 2 never finish.
    assert (None in first_done) == (eos_idx == 5)
    for blocks in (jblocks, tblocks):
        for index in (6, 7):  # step_attn_cmd, step_attn_sit
            attn = np.concatenate([b[index] for b in blocks])
            for row, step in enumerate(first_done):
                for later in range(attn.shape[0] if step is None
                                   else step + 1, attn.shape[0]):
                    np.testing.assert_array_equal(
                        attn[later, row], attn[step, row],
                        err_msg="row {} step {}".format(row, later))


def test_decode_block_records_top2_gap(decoder_setup):
    config, _, tparams, txt, mask, vis, h, c = decoder_setup
    batch = txt.shape[0]
    gaps = []
    out = k2.decode_block_plain(
        torch.from_numpy(txt), torch.from_numpy(mask), torch.from_numpy(vis),
        torch.from_numpy(h), torch.from_numpy(c),
        torch.full((batch,), 1, dtype=torch.int32),
        torch.zeros((batch,), dtype=torch.bool),
        k2.pack_decoder_weights(tparams, config.target_pad_idx),
        num_steps=5, eos_idx=2, top2_gap=gaps)
    assert len(gaps) == 5 and gaps[0].shape == (batch,)
    assert all(bool((g >= 0).all()) for g in gaps)
    assert out.step_tokens.shape == (5, batch)
