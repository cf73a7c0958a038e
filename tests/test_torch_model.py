"""The port's model functions equal the JAX package's on the CPU.

Same weights (JAX-initialised, carried across with ``params_from_numpy``) and
the same numpy-seeded inputs go through ``encode_input``,
``initialize_decoder_hidden``, ``project_keys`` and ``decoder_step`` of both
packages at the small H=12 configuration of tests/test_pallas_decoder.py.

Tolerance: rtol 1e-5 / atol 1e-5 on every float output, 20x tighter than the
reference-parity bar of tests/test_model_parity.py (atol 2e-4 / rtol 1e-3).
Both sides compute in float32 on the CPU; they differ only in the order of
the sums inside each matmul and conv (XLA's vs PyTorch's), which moves a
float32 result of these magnitudes by ~1e-6 at most.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_seq2seq_gscan_tpu.models import model as jax_model
from multimodal_seq2seq_gscan_tpu.models import ModelConfig as JaxConfig
from multimodal_seq2seq_gscan_tpu.models import init_model_params
from multimodal_seq2seq_gscan_tpu.models import count_parameters as jax_count
from multimodal_seq2seq_gscan_tpu_torch.models import model as torch_model
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.params import (
    count_parameters, params_from_numpy)

RTOL = ATOL = 1e-5


def carry_params(jax_params):
    """JAX ModelParams -> the port's params on the CPU."""
    tree = jax.tree.map(np.asarray,
                        flax.serialization.to_state_dict(jax_params))
    return params_from_numpy(tree, device="cpu")


def small_config(**overrides):
    kwargs = dict(input_vocabulary_size=12, target_vocabulary_size=9,
                  num_cnn_channels=8, embedding_dimension=8,
                  encoder_hidden_size=12, decoder_hidden_size=12,
                  cnn_kernel_size=3, cnn_hidden_num_channels=6)
    kwargs.update(overrides)
    return JaxConfig(**kwargs), ModelConfig(**kwargs)


def random_batch(seed, batch=7, t_in=8, grid=5, channels=8, vocab=12):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(3, t_in + 1, size=batch).astype(np.int32)
    ids = np.zeros((batch, t_in), np.int32)
    for i in range(batch):
        ids[i, 0] = 1
        ids[i, 1:lengths[i] - 1] = rng.randint(3, vocab, size=lengths[i] - 2)
        ids[i, lengths[i] - 1] = 2
    situations = rng.rand(batch, grid, grid, channels).astype(np.float32)
    return ids, lengths, situations


def close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


CASES = {
    "flagship_shape": {},
    "unconditional": {"conditional_attention": False},
    "two_layers": {"num_encoder_layers": 2, "num_decoder_layers": 2},
    "unidirectional": {"encoder_bidirectional": False},
}


@pytest.fixture(scope="module", params=sorted(CASES))
def both(request):
    jcfg, tcfg = small_config(**CASES[request.param])
    jparams = init_model_params(jax.random.PRNGKey(2), jcfg)
    ids, lengths, situations = random_batch(0)
    jenc = jax_model.encode_input(jparams, jcfg, jnp.asarray(ids),
                                  jnp.asarray(lengths),
                                  jnp.asarray(situations))
    tparams = carry_params(jparams)
    tenc = torch_model.encode_input(tparams, tcfg, torch.from_numpy(ids),
                                    torch.from_numpy(lengths),
                                    torch.from_numpy(situations))
    return jcfg, tcfg, jparams, tparams, jenc, tenc


def test_encode_input(both):
    *_, jenc, tenc = both
    for field in jenc._fields:
        close(getattr(tenc, field), getattr(jenc, field))


def test_initial_hidden_and_projected_keys(both):
    jcfg, tcfg, jparams, tparams, jenc, tenc = both
    for port, ref in zip(
            torch_model.initialize_decoder_hidden(tparams, tcfg, tenc.hidden),
            jax_model.initialize_decoder_hidden(jparams, jcfg, jenc.hidden)):
        close(port, ref)
    for port, ref in zip(torch_model.project_keys(tparams, tenc),
                         jax_model.project_keys(jparams, jenc)):
        close(port, ref)


def test_decoder_steps(both):
    """Three chained decoder steps, fed the same (JAX-chosen) tokens."""
    jcfg, tcfg, jparams, tparams, jenc, tenc = both
    jtxt, jvis = jax_model.project_keys(jparams, jenc)
    ttxt, tvis = torch_model.project_keys(tparams, tenc)
    jhidden = jax_model.initialize_decoder_hidden(jparams, jcfg, jenc.hidden)
    thidden = torch_model.initialize_decoder_hidden(tparams, tcfg,
                                                    tenc.hidden)
    tokens = np.full((jenc.hidden.shape[0],), 1, np.int32)
    for _ in range(3):
        jout = jax_model.decoder_step(jparams, jcfg, jnp.asarray(tokens),
                                      jhidden, jtxt, jenc.command_mask, jvis)
        tout = torch_model.decoder_step(tparams, tcfg,
                                        torch.from_numpy(tokens), thidden,
                                        ttxt, tenc.command_mask, tvis)
        jlogits, jhidden, jattn_cmd, jattn_sit = jout
        tlogits, thidden, tattn_cmd, tattn_sit = tout
        close(tlogits, jlogits)
        close(thidden[0], jhidden[0])
        close(thidden[1], jhidden[1])
        close(tattn_cmd, jattn_cmd)
        close(tattn_sit, jattn_sit)
        tokens = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)


def test_flagship_parameter_count():
    """440,275 parameters at the canonical compositional-splits widths."""
    kwargs = dict(input_vocabulary_size=21, target_vocabulary_size=9,
                  num_cnn_channels=16, embedding_dimension=25,
                  encoder_hidden_size=100, decoder_hidden_size=100,
                  cnn_kernel_size=7, cnn_hidden_num_channels=50)
    shapes = jax.eval_shape(
        lambda key: init_model_params(key, JaxConfig(**kwargs)),
        jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    assert count_parameters(carry_params(zeros)) == jax_count(shapes) \
        == 440275
