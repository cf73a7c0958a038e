"""The port's teacher-forced unroll and kernel 1's backward equal the JAX
package's, on the CPU.

At the tiny configuration of tests/test_pallas_teacher_forced.py (B=6, H=12,
11 steps padded to 16, a p=0.3 dropout mask), the same numpy inputs go
through JAX's ``fused_teacher_forced`` (Pallas, interpret mode) with
``jax.vjp``, and through the port's:
- ``teacher_forced_plain`` with autograd (the ``"plain"`` impl);
- ``fused_teacher_forced``, whose wrappers take their kernels' plain twins on
  CPU tensors: the forward, the port of the TPU backward kernel's step math
  (``teacher_forced_backward_plain``) and the weight-gradient sums from its
  stash (``weight_grads_plain``), wired by ``FusedTeacherForced``.
Bars are the JAX test's: logits rtol/atol 1e-5, summed attention rtol 1e-5 /
atol 1e-6, gradients rtol 2e-4 / atol 2e-5. Kernel 1's new backward
(``attention_vjp_plain``, the port of ``_attention_bwd``) is held against
``jax.vjp`` of ``fused_additive_attention`` at the JAX attention gradient
test's bar (atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_seq2seq_gscan_tpu.models import ModelConfig, init_model_params
from multimodal_seq2seq_gscan_tpu.models.model import (
    encode_input, initialize_decoder_hidden, project_keys)
from multimodal_seq2seq_gscan_tpu.ops.pallas_attention import (
    fused_additive_attention)
from multimodal_seq2seq_gscan_tpu.ops.pallas_decoder import (
    pack_decoder_weights)
from multimodal_seq2seq_gscan_tpu.ops.pallas_teacher_forced import (
    fused_teacher_forced as jax_fused)
from multimodal_seq2seq_gscan_tpu_torch.ops import additive_attention as k1
from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
from multimodal_seq2seq_gscan_tpu_torch.ops.decode_block import (
    DecoderWeights)

BATCH, T_IN, GRID, CH, V_IN = 6, 7, 5, 8, 12
NUM_STEPS, T_PAD = 11, 16


@pytest.fixture(scope="module")
def reference():
    """Inputs as the JAX test draws them, and JAX's outputs and gradients."""
    config = ModelConfig(input_vocabulary_size=V_IN, target_vocabulary_size=9,
                         num_cnn_channels=CH, embedding_dimension=8,
                         encoder_hidden_size=12, decoder_hidden_size=12,
                         cnn_kernel_size=3, cnn_hidden_num_channels=6)
    params = init_model_params(jax.random.PRNGKey(4), config)
    rng = np.random.RandomState(1)
    input_lengths = rng.randint(3, T_IN + 1, size=BATCH).astype(np.int32)
    input_ids = np.zeros((BATCH, T_IN), dtype=np.int32)
    for i in range(BATCH):
        input_ids[i, :input_lengths[i]] = rng.randint(1, V_IN,
                                                      size=input_lengths[i])
    situations = rng.rand(BATCH, GRID, GRID, CH).astype(np.float32)
    encoded = encode_input(params, config, jnp.asarray(input_ids),
                           jnp.asarray(input_lengths),
                           jnp.asarray(situations), deterministic=True)
    proj_txt, proj_vis = project_keys(params, encoded)
    h_stack, c_stack = initialize_decoder_hidden(params, config,
                                                 encoded.hidden)
    weights = pack_decoder_weights(params, config.target_pad_idx)
    tokens = rng.randint(0, 9, size=(T_PAD, BATCH)).astype(np.int32)
    tokens[NUM_STEPS:] = config.target_pad_idx
    drop = (rng.rand(T_PAD, BATCH, weights[6].shape[1]) > 0.3).astype(
        np.float32) / 0.7
    inputs = (proj_txt, encoded.command_mask, proj_vis, h_stack[0],
              c_stack[0], jnp.asarray(tokens), jnp.asarray(drop), weights)
    cot = np.random.RandomState(7)
    w_log = cot.randn(NUM_STEPS, BATCH, 9).astype(np.float32)
    w_asum = cot.randn(BATCH, proj_vis.shape[1]).astype(np.float32)

    def fused(p_txt, p_vis, h0, c0, w):
        return jax_fused(p_txt, inputs[1], p_vis, h0, c0, inputs[5],
                         inputs[6], w, NUM_STEPS, 3, True)

    (logits, asum), vjp = jax.vjp(fused, inputs[0], inputs[2], inputs[3],
                                  inputs[4], weights)
    d_log = np.zeros((T_PAD, BATCH, 9), np.float32)
    d_log[:NUM_STEPS] = w_log
    grads = vjp((jnp.asarray(d_log), jnp.asarray(w_asum)))
    numpy = [np.array(x) for x in inputs[:7]]
    return dict(inputs=numpy, weights=[np.array(w) for w in weights],
                d_log=d_log, w_asum=w_asum, logits=np.asarray(logits),
                asum=np.asarray(asum),
                grads=[np.asarray(g) for g in grads[:4]]
                + [np.asarray(g) for g in grads[4]])


def port_run(reference, impl):
    """The port's unroll on the reference inputs: (logits, asum, grads of
    proj_txt, proj_vis, h0, c0 and the 12 packed weights)."""
    arrays = [torch.from_numpy(x) for x in reference["inputs"]]
    leaves = [arrays[i].clone().requires_grad_(True) for i in (0, 2, 3, 4)]
    weights = [torch.from_numpy(w).requires_grad_(True)
               for w in reference["weights"]]
    unroll = {"plain": tf.teacher_forced_plain,
              "fused": tf.fused_teacher_forced}[impl]
    logits, asum = unroll(leaves[0], arrays[1], leaves[1], leaves[2],
                          leaves[3], arrays[5], arrays[6],
                          DecoderWeights(*weights), num_steps=NUM_STEPS)
    loss = (logits * torch.from_numpy(reference["d_log"])).sum() \
        + (asum * torch.from_numpy(reference["w_asum"])).sum()
    grads = torch.autograd.grad(loss, leaves + weights)
    return logits.detach(), asum.detach(), grads


@pytest.mark.parametrize("impl", ["plain", "fused"])
def test_forward_matches_jax(reference, impl):
    logits, asum, _ = port_run(reference, impl)
    np.testing.assert_allclose(logits[:NUM_STEPS].numpy(),
                               reference["logits"][:NUM_STEPS],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(asum.numpy(), reference["asum"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("impl", ["plain", "fused"])
def test_gradients_match_jax(reference, impl):
    _, _, grads = port_run(reference, impl)
    names = ["proj_txt", "proj_vis", "h0", "c0"] + list(
        DecoderWeights._fields)
    assert len(grads) == len(reference["grads"]) == 16
    for name, port, ref in zip(names, grads, reference["grads"]):
        np.testing.assert_allclose(port.numpy(), ref, rtol=2e-4, atol=2e-5,
                                   err_msg=name)


def test_fused_plain_twins_count_no_launch(reference):
    before = dict(tf.launches)
    port_run(reference, "fused")
    assert tf.launches == before  # CPU tensors take the plain twins


@pytest.mark.parametrize("masked", [True, False])
def test_attention_backward_matches_jax(masked):
    """Kernel 1's backward (the plain port of ``_attention_bwd``) against
    ``jax.vjp`` of the Pallas attention, both cotangents non-zero; row 6 is
    all-masked (uniform weights, and the same gradient as the JAX
    function's)."""
    batch, m, h = 9, 17, 16
    rng = np.random.RandomState(3)
    pq = rng.randn(batch, h).astype(np.float32)
    keys = rng.randn(batch, m, h).astype(np.float32)
    energy = (rng.randn(h, 1) / np.sqrt(h)).astype(np.float32)
    lengths = np.array([m, 3, 5, m, 1, 8, 0, 2, 9]) if masked \
        else np.full(batch, m)
    mask = (np.arange(m)[None] < lengths[:, None]).astype(np.float32)
    d_ctx = rng.randn(batch, h).astype(np.float32)
    d_w = rng.randn(batch, m).astype(np.float32)

    def attention(q, k, e):
        return fused_additive_attention(q, k, jnp.asarray(mask), e,
                                        interpret=True)

    (_, weights), vjp = jax.vjp(attention, jnp.asarray(pq),
                                jnp.asarray(keys), jnp.asarray(energy))
    want = vjp((jnp.asarray(d_ctx), jnp.asarray(d_w)))
    d_pq, d_keys, d_energy_rows = k1.attention_vjp_plain(
        torch.from_numpy(pq), torch.from_numpy(keys),
        torch.from_numpy(np.array(weights)), torch.from_numpy(energy),
        torch.from_numpy(d_ctx), torch.from_numpy(d_w))
    got = (d_pq, d_keys, d_energy_rows.sum(dim=0)[:, None])
    for name, port, ref in zip(("pq", "keys", "energy"), got, want):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-5,
                                   err_msg=name)
