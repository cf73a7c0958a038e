"""The port at shapes past the CUDA kernels' register-resident attention
(M > 64 keys, H > 128) equals the JAX package, on the CPU.

The gSCAN generator takes any grid size, and a 9x9 grid gives M_v = 81
visual keys; H and E may be any width. On the card every kernel takes these
shapes (tests/test_torch_kernels.py::test_wide_shapes_match_plain holds
them against the plain versions); here the plain versions are held against
the JAX package, with its Pallas kernels in interpret mode as its own tests
run them:
- the attention forward and VJP at M = 81 unmasked and M = 72 masked
  (lengths 0..72, so the mask falls past the 64th key), H = 136;
- the decode block at H = 136, M_v = 81;
- the teacher-forced unroll (logits, summed attention and all 16 gradients)
  at H = E = 136 with M_v = 81, at H = E = 256 with M_t = 72 and a 12x12
  grid (M_v = 144), and at H = E = 512 (M_t = 16, M_v = 36: a width that
  kernels 3 and 4 serve on the card with their grid plans only), each at
  B <= 4 and T = 8 (the JAX kernel's block of steps);
- one ``train_step`` and one ``evaluate`` of a tiny model on a 9x9 grid.
Bars are the JAX tests': attention context atol 1e-5, weights atol 1e-6,
gradients atol 1e-5; decode-block tokens equal, attention, h and c rtol 1e-5
/ atol 1e-6; teacher-forced logits rtol/atol 1e-5, summed attention rtol
1e-5 / atol 1e-6, gradients rtol 2e-4 / atol 2e-5; a train step's loss rtol
1e-5, gradients rtol 3e-4 / atol 3e-5, updated params atol 1e-6;
``evaluate``'s three metrics atol 1e-6.
"""

import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_seq2seq_gscan_tpu.core.batch import Batch as JaxBatch
from multimodal_seq2seq_gscan_tpu.data.dataset import (
    GroundedScanDataset as JaxDataset)
from multimodal_seq2seq_gscan_tpu.decode.predict import (
    evaluate as jax_evaluate)
from multimodal_seq2seq_gscan_tpu.models import ModelConfig as JaxConfig
from multimodal_seq2seq_gscan_tpu.models import init_model_params
from multimodal_seq2seq_gscan_tpu.ops import pallas_decoder
from multimodal_seq2seq_gscan_tpu.ops.pallas_attention import (
    fused_additive_attention)
from multimodal_seq2seq_gscan_tpu.ops.pallas_teacher_forced import (
    fused_teacher_forced as jax_fused)
from multimodal_seq2seq_gscan_tpu.train.state import (
    TrainState as JaxState)
from multimodal_seq2seq_gscan_tpu.train.state import make_optimizer
from multimodal_seq2seq_gscan_tpu.train.step import (
    loss_fn as jax_loss_fn)
from multimodal_seq2seq_gscan_tpu.train.step import train_step_body
from multimodal_seq2seq_gscan_tpu_torch.core.batch import Batch
from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
    GroundedScanDataset)
from multimodal_seq2seq_gscan_tpu_torch.decode.predict import evaluate
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.params import (
    leaves, params_from_numpy)
from multimodal_seq2seq_gscan_tpu_torch.ops import additive_attention as k1
from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
from multimodal_seq2seq_gscan_tpu_torch.train.state import (
    Adam, AdamState, TrainState)
from multimodal_seq2seq_gscan_tpu_torch.train.step import (
    loss_and_grads, train_step)
from tests.test_torch_train import random_opt_state, tiny_kwargs

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "data",
                       "bench_fixture")
VOCAB, EOS = 9, 2


@pytest.mark.parametrize("m,masked", [(81, False), (72, True)])
def test_attention_wide_matches_jax(m, masked):
    """Forward and VJP at H = 136; masked rows have lengths 0..M (row 0 is
    all-masked: uniform weights, as in the JAX function)."""
    batch, h = 5, 136
    rng = np.random.RandomState(m)
    pq = rng.randn(batch, h).astype(np.float32)
    keys = rng.randn(batch, m, h).astype(np.float32)
    energy = (rng.randn(h, 1) / np.sqrt(h)).astype(np.float32)
    lengths = np.array([0, 7, 64, 66, m]) if masked else np.full(batch, m)
    mask = (np.arange(m)[None] < lengths[:, None]).astype(np.float32)
    d_ctx = rng.randn(batch, h).astype(np.float32)
    d_w = rng.randn(batch, m).astype(np.float32)

    def attention(q, k, e):
        return fused_additive_attention(q, k, jnp.asarray(mask), e,
                                        interpret=True)

    (ctx_ref, w_ref), vjp = jax.vjp(attention, jnp.asarray(pq),
                                    jnp.asarray(keys), jnp.asarray(energy))
    want = vjp((jnp.asarray(d_ctx), jnp.asarray(d_w)))
    tensors = [torch.from_numpy(x) for x in (pq, keys, energy)]
    ctx, w = k1.additive_attention(
        tensors[0], tensors[1],
        torch.from_numpy(mask) if masked else None, tensors[2])
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_ref), atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=1e-6)
    d_pq, d_keys, d_energy_rows = k1.attention_vjp_plain(
        tensors[0], tensors[1], w, tensors[2], torch.from_numpy(d_ctx),
        torch.from_numpy(d_w))
    got = (d_pq, d_keys, d_energy_rows.sum(dim=0)[:, None])
    for name, port, ref in zip(("pq", "keys", "energy"), got, want):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-5,
                                   err_msg=name)


def decoder_weights(rng, h, e, vocab):
    """The 12 packed decoder weights, drawn as the JAX package initialises
    them (uniform in +-1/sqrt(fan_in), embedding N(0, 1), pad row 0)."""
    def uniform(shape, fan_in):
        return (rng.uniform(-1, 1, shape) / np.sqrt(fan_in)).astype(
            np.float32)

    embedding = rng.randn(vocab, e).astype(np.float32)
    embedding[0] = 0.0
    return [uniform((h, h), h), uniform((h, 1), h),
            uniform((2 * h, h), 2 * h), uniform((1, h), 2 * h),
            uniform((h, h), h), uniform((h, 1), h), embedding,
            uniform((e + 2 * h, 4 * h), h), uniform((h, 4 * h), h),
            uniform((1, 4 * h), h), uniform((e + 3 * h, h), e + 3 * h),
            uniform((h, vocab), h)]


def keys_and_state(rng, batch, m_t, m_v, h):
    lengths = np.array([m_t, 1] + list(rng.randint(1, m_t + 1,
                                                   size=batch - 2)))
    mask = (np.arange(m_t)[None] < lengths[:, None]).astype(np.float32)
    return [rng.randn(batch, m_t, h).astype(np.float32), mask,
            rng.randn(batch, m_v, h).astype(np.float32),
            np.tanh(rng.randn(batch, h)).astype(np.float32),
            (rng.randn(batch, h) * 0.5).astype(np.float32)]


@pytest.mark.parametrize("h,m_v", [(136, 81), (449, 36), (1024, 36)])
def test_decode_block_wide_matches_pallas(h, m_v):
    """Two chained 4-step blocks from SOS at H = 136, M_v = 81 (a 9x9
    grid), and at the widths the card serves with kernel 2's grid plan (H =
    449 and 1024, M_v = 36): the plain version (the card's referee) against
    the Pallas kernel in interpret mode; one row starts done."""
    batch, m_t = 4, 16
    rng = np.random.RandomState(3)
    state = keys_and_state(rng, batch, m_t, m_v, h)
    weights = decoder_weights(rng, h, h, VOCAB)
    done = np.array([False, False, True, False])
    jstate = (jnp.asarray(state[3]), jnp.asarray(state[4]),
              jnp.full((batch,), 1, jnp.int32), jnp.asarray(done))
    tstate = (torch.from_numpy(state[3]), torch.from_numpy(state[4]),
              torch.full((batch,), 1, dtype=torch.int32),
              torch.from_numpy(done))
    for _ in range(2):
        ref = pallas_decoder.fused_decode_block(
            *(jnp.asarray(x) for x in state[:3]), *jstate,
            tuple(jnp.asarray(w) for w in weights), num_steps=4, sos_idx=1,
            eos_idx=EOS, interpret=True)
        out = k2.fused_decode_block(
            *(torch.from_numpy(x) for x in state[:3]), *tstate,
            k2.DecoderWeights(*(torch.from_numpy(w) for w in weights)),
            num_steps=4, eos_idx=EOS)
        ref = [np.asarray(x) for x in ref]
        for name, got, want in zip(k2.BlockOutput._fields, out, ref):
            if name in ("tokens", "done", "step_tokens", "step_emitted"):
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=name)
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                           atol=1e-6, err_msg=name)
        jstate = tuple(jnp.asarray(x) for x in ref[:4])
        tstate = out[:4]


TEACHER_FORCED_SHAPES = {
    "H136-Mv81": dict(batch=4, steps=8, num_steps=6, m_t=16, m_v=81, h=136),
    "H256-Mt72-Mv144": dict(batch=3, steps=8, num_steps=7, m_t=72, m_v=144,
                            h=256),
    # The first width past kernels 3 and 4's cluster plans that JAX trains
    # and the card once refused: their grid plans serve it there.
    "H512": dict(batch=2, steps=8, num_steps=6, m_t=16, m_v=36, h=512),
}


@pytest.mark.parametrize("impl", ["plain", "fused"])
@pytest.mark.parametrize("shape", sorted(TEACHER_FORCED_SHAPES))
def test_teacher_forced_wide_matches_jax(shape, impl):
    """Logits, summed attention and the gradients of the keys, h0, c0 and
    the 12 weights, against ``jax.vjp`` of the Pallas unroll (interpret
    mode); "fused" runs the kernels' wrappers, which take their plain twins
    on CPU tensors."""
    s = TEACHER_FORCED_SHAPES[shape]
    batch, steps, num_steps, h = s["batch"], s["steps"], s["num_steps"], \
        s["h"]
    rng = np.random.RandomState(h + s["m_v"])
    proj_txt, mask, proj_vis, h0, c0 = keys_and_state(rng, batch, s["m_t"],
                                                      s["m_v"], h)
    weights = decoder_weights(rng, h, h, VOCAB)
    tokens = rng.randint(0, VOCAB, size=(steps, batch)).astype(np.int32)
    tokens[num_steps:] = 0
    drop = ((rng.rand(steps, batch, h) > 0.3) / 0.7).astype(np.float32)
    d_log = np.zeros((steps, batch, VOCAB), np.float32)
    d_log[:num_steps] = rng.randn(num_steps, batch, VOCAB)
    w_asum = rng.randn(batch, s["m_v"]).astype(np.float32)

    def fused(p_txt, p_vis, h_0, c_0, w):
        return jax_fused(p_txt, jnp.asarray(mask), p_vis, h_0, c_0,
                         jnp.asarray(tokens), jnp.asarray(drop), w,
                         num_steps, batch, True)

    (logits_ref, asum_ref), vjp = jax.vjp(
        fused, *(jnp.asarray(x) for x in (proj_txt, proj_vis, h0, c0)),
        tuple(jnp.asarray(w) for w in weights))
    grads_ref = vjp((jnp.asarray(d_log), jnp.asarray(w_asum)))
    grads_ref = list(grads_ref[:4]) + list(grads_ref[4])

    leaves_ = [torch.from_numpy(x).requires_grad_(True)
               for x in [proj_txt, proj_vis, h0, c0] + weights]
    unroll = {"plain": tf.teacher_forced_plain,
              "fused": tf.fused_teacher_forced}[impl]
    logits, asum = unroll(
        leaves_[0], torch.from_numpy(mask), leaves_[1], leaves_[2],
        leaves_[3], torch.from_numpy(tokens), torch.from_numpy(drop),
        k2.DecoderWeights(*leaves_[4:]), num_steps=num_steps)
    np.testing.assert_allclose(logits[:num_steps].detach().numpy(),
                               np.asarray(logits_ref)[:num_steps],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(asum.detach().numpy(), np.asarray(asum_ref),
                               rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad(
        (logits * torch.from_numpy(d_log)).sum()
        + (asum * torch.from_numpy(w_asum)).sum(), leaves_)
    names = ["proj_txt", "proj_vis", "h0", "c0"] + list(
        k2.DecoderWeights._fields)
    for name, port, ref in zip(names, grads, grads_ref):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


GRID = 9


def batch_on_grid(seed, batch=4, t_in=7, t_out=11, channels=8, v_in=12):
    """Random examples on a 9x9 grid, the last row all padding."""
    rng = np.random.RandomState(seed)
    input_lengths = rng.randint(3, t_in + 1, size=batch).astype(np.int32)
    input_ids = np.zeros((batch, t_in), np.int32)
    targets = np.zeros((batch, t_out), np.int32)
    target_lengths = np.zeros(batch, np.int32)
    for i in range(batch - 1):
        input_ids[i, :input_lengths[i]] = rng.randint(1, v_in,
                                                      size=input_lengths[i])
        n = rng.randint(4, t_out)
        targets[i, 0] = 1
        targets[i, 1:n - 1] = rng.randint(3, VOCAB, size=n - 2)
        targets[i, n - 1] = EOS
        target_lengths[i] = n
    input_lengths[-1] = 0
    arrays = dict(
        input_ids=input_ids, input_lengths=input_lengths,
        situations=rng.rand(batch, GRID, GRID, channels).astype(np.float32),
        target_ids=targets, target_lengths=target_lengths,
        agent_positions=rng.randint(0, GRID * GRID, batch).astype(np.int32),
        target_positions=rng.randint(0, GRID * GRID,
                                     batch).astype(np.int32))
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            Batch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def to_torch(tree):
    return params_from_numpy(flax.serialization.to_state_dict(tree),
                             device="cpu")


def test_train_step_on_a_9x9_grid_matches_jax():
    """One whole train step ("fused", dropout off, the auxiliary task on)
    of a tiny model (H = 12) whose visual attention runs over 81 keys,
    against JAX ``train_step_body``."""
    kwargs = tiny_kwargs(encoder_dropout_p=0.0, decoder_dropout_p=0.0,
                         cnn_dropout_p=0.0, auxiliary_task=True)
    jax_config = JaxConfig(**kwargs)
    config = ModelConfig(teacher_forced_impl="fused", **kwargs)
    params = init_model_params(jax.random.PRNGKey(8), jax_config)
    opt_state = random_opt_state(params, 7, seed=5)
    jax_batch, batch = batch_on_grid(13)
    state = JaxState(step=jnp.int32(7), params=params, opt_state=opt_state,
                     rng=jax.random.PRNGKey(2))
    optimizer = make_optimizer()

    @jax.jit
    def reference(state, batch):
        (loss, _), grads = jax.value_and_grad(jax_loss_fn, has_aux=True)(
            state.params, jax_config, batch,
            jax.random.fold_in(state.rng, state.step), 0.3)
        return train_step_body(state, batch, jax_config, optimizer, 0.3), \
            loss, grads

    (new_state, _), loss, grads = reference(state, jax_batch)
    port_state = TrainState(
        step=7, params=to_torch(params),
        opt_state=AdamState(7, to_torch(opt_state[0].mu),
                            to_torch(opt_state[0].nu), 7),
        rng=np.asarray(state.rng))
    port_loss, _, port_grads = loss_and_grads(port_state, batch, config)
    new_port, metrics = train_step(port_state, batch, config, Adam())
    np.testing.assert_allclose(float(port_loss), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                               rtol=1e-5)
    for port, ref in zip(leaves(port_grads), jax.tree.leaves(grads)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=3e-4,
                                   atol=3e-5)
    for port, ref in zip(leaves(new_port.params),
                         jax.tree.leaves(new_state.params)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)


def test_evaluate_on_a_9x9_grid_matches_jax(tmp_path):
    """``evaluate`` of a tiny random model (the flagship decoder: block
    decode, conditional attention, the auxiliary head) over the fixture's
    first 24 dev examples placed on a 9x9 grid, against JAX's."""
    with open(os.path.join(FIXTURE, "dataset.txt")) as f:
        data = json.load(f)
    data["grid_size"] = GRID
    data["examples"] = {"dev": data["examples"]["dev"][:24]}
    for example in data["examples"]["dev"]:
        example["situation"]["grid_size"] = GRID
    path = str(tmp_path / "dataset.txt")
    with open(path, "w") as f:
        json.dump(data, f)
    jax_data = JaxDataset(path, FIXTURE, k=0, split="dev",
                          input_vocabulary_file="training_input_vocab.txt",
                          target_vocabulary_file="training_target_vocab.txt",
                          generate_vocabulary=False)
    jax_data.read_dataset()
    port_data = GroundedScanDataset(path, FIXTURE, split="dev")
    port_data.read_dataset()
    kwargs = dict(input_vocabulary_size=port_data.input_vocabulary_size,
                  target_vocabulary_size=port_data.target_vocabulary_size,
                  num_cnn_channels=port_data.image_channels,
                  embedding_dimension=8, encoder_hidden_size=12,
                  decoder_hidden_size=12, cnn_kernel_size=3,
                  cnn_hidden_num_channels=6, auxiliary_task=True)
    jax_params = init_model_params(jax.random.PRNGKey(6), JaxConfig(**kwargs))
    ref = jax_evaluate(jax_data, jax_params, JaxConfig(**kwargs), 20,
                       batch_size=16)
    got = evaluate(port_data, to_torch(jax_params), ModelConfig(**kwargs), 20,
                   batch_size=16, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
