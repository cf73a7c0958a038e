"""The port's data path and greedy decode equal the JAX package's.

- Batches of the first 256 dev examples of data/bench_fixture are identical
  to the JAX loader's (bucketed lengths, zero-row padding of a short batch).
- The port's decode of them (CPU, plain versions of the kernels) is
  token-identical to JAX's ``make_greedy_decoder`` (XLA, float32) on the
  trained fixture checkpoint, with the same exact match; both attention
  stacks agree to atol 1e-5 (float32 sums in another order, over chained
  decoder steps).
- At the small H=12 configuration every ``decode_impl`` of the port gives
  JAX's tokens, lengths and emitted flags, with early exit and a final block
  that runs past the step cap.
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_seq2seq_gscan_tpu.data.dataset import (
    GroundedScanDataset as JaxDataset)
from multimodal_seq2seq_gscan_tpu.decode.greedy import (
    make_greedy_decoder as jax_decoder)
from multimodal_seq2seq_gscan_tpu.decode.greedy import (
    strip_output_sequences as jax_strip)
from multimodal_seq2seq_gscan_tpu.models import ModelConfig as JaxConfig
from multimodal_seq2seq_gscan_tpu.models import init_model_params
from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
    GroundedScanDataset)
from multimodal_seq2seq_gscan_tpu_torch.decode.greedy import (
    DECODE_IMPLS, make_greedy_decoder, strip_output_sequences)
from multimodal_seq2seq_gscan_tpu_torch.decode.predict import evaluate
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.params import (
    params_from_numpy)
from multimodal_seq2seq_gscan_tpu_torch.train.checkpoint import (
    load_params, read_checkpoint)

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "data",
                       "bench_fixture")
N_EXAMPLES = 256


def fixture_datasets():
    jax_data = JaxDataset(
        os.path.join(FIXTURE, "dataset.txt"), FIXTURE, k=0, split="dev",
        input_vocabulary_file="training_input_vocab.txt",
        target_vocabulary_file="training_target_vocab.txt",
        generate_vocabulary=False)
    jax_data.read_dataset(max_examples=N_EXAMPLES)
    port_data = GroundedScanDataset(os.path.join(FIXTURE, "dataset.txt"),
                                    FIXTURE, split="dev")
    port_data.read_dataset(max_examples=N_EXAMPLES)
    return jax_data, port_data


@pytest.fixture(scope="module")
def fixture():
    jax_data, port_data = fixture_datasets()
    kwargs = dict(input_vocabulary_size=port_data.input_vocabulary_size,
                  target_vocabulary_size=port_data.target_vocabulary_size,
                  num_cnn_channels=port_data.image_channels)
    path = os.path.join(FIXTURE, "model_best.msgpack")
    template = jax.eval_shape(
        lambda key: init_model_params(key, JaxConfig(**kwargs)),
        jax.random.PRNGKey(0))
    jax_params = flax.serialization.from_state_dict(
        template, read_checkpoint(path)["params"])
    return (jax_data, port_data, JaxConfig(**kwargs), ModelConfig(**kwargs),
            jax_params, load_params(path, device="cpu"))


@pytest.mark.parametrize("batch_size", [256, 100])
def test_batches_identical_to_jax_loader(fixture, batch_size):
    jax_data, port_data = fixture[:2]
    jax_batches = list(jax_data.get_data_iterator(
        batch_size=batch_size, pad_to_full_batch=True,
        with_representations=False))
    port_batches = list(port_data.get_data_iterator(
        batch_size=batch_size, pad_to_full_batch=True))
    assert len(port_batches) == len(jax_batches) == -(-N_EXAMPLES
                                                      // batch_size)
    for (jbatch, jidx, _, _), (pbatch, pidx, _, _) in zip(jax_batches,
                                                          port_batches):
        np.testing.assert_array_equal(pidx, jidx)
        for field in jbatch._fields:
            port = getattr(pbatch, field).numpy()
            ref = np.asarray(getattr(jbatch, field))
            assert port.dtype == ref.dtype, field
            np.testing.assert_array_equal(port, ref, err_msg=field)


def test_fixture_decode_token_identical_to_jax(fixture):
    jax_data, port_data, jcfg, tcfg, jparams, tparams = fixture
    jbatch, jidx, _, _ = next(jax_data.get_data_iterator(
        batch_size=N_EXAMPLES, pad_to_full_batch=True,
        with_representations=False))
    ref = jax_decoder(jcfg, max_decoding_steps=120, early_exit=True,
                      decode_impl="xla", compute_dtype="float32")(
        jparams, jbatch.input_ids, jbatch.input_lengths, jbatch.situations,
        jbatch.target_positions)
    pbatch = next(port_data.get_data_iterator(batch_size=N_EXAMPLES,
                                              pad_to_full_batch=True))[0]
    out = make_greedy_decoder(tcfg, 120)(
        tparams, pbatch.input_ids, pbatch.input_lengths, pbatch.situations,
        pbatch.target_positions)

    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(out.emitted_mask.numpy(),
                                  np.asarray(ref.emitted_mask))
    emitted = np.asarray(ref.emitted_mask) > 0
    np.testing.assert_array_equal(out.tokens.numpy() * emitted,
                                  np.asarray(ref.tokens) * emitted)
    for field in ("attention_commands", "attention_situations"):
        np.testing.assert_allclose(
            getattr(out, field).numpy() * emitted[..., None],
            np.asarray(getattr(ref, field)) * emitted[..., None], atol=1e-5)

    port_sequences, _ = strip_output_sequences(out, tcfg.target_eos_idx)
    ref_sequences, _ = jax_strip(ref, jcfg.target_eos_idx)
    assert port_sequences == ref_sequences
    targets = [port_data.target_ids[i][1:-1].tolist() for i in range(256)]
    matched = sum(s == t for s, t in zip(port_sequences, targets))
    _, exact_match, _ = evaluate(port_data, tparams, tcfg, 120,
                                 batch_size=128, device="cpu")
    assert exact_match == 100.0 * matched / N_EXAMPLES > 90.0


@pytest.fixture(scope="module")
def small():
    kwargs = dict(input_vocabulary_size=12, target_vocabulary_size=9,
                  num_cnn_channels=8, embedding_dimension=8,
                  encoder_hidden_size=12, decoder_hidden_size=12,
                  cnn_kernel_size=3, cnn_hidden_num_channels=6)
    jcfg = JaxConfig(**kwargs)
    jparams = init_model_params(jax.random.PRNGKey(2), jcfg)
    tree = jax.tree.map(np.asarray,
                        flax.serialization.to_state_dict(jparams))
    rng = np.random.RandomState(0)
    batch, t_in = 7, 8
    lengths = rng.randint(3, t_in + 1, size=batch).astype(np.int32)
    ids = np.zeros((batch, t_in), np.int32)
    for i in range(batch):
        ids[i, 0] = 1
        ids[i, 1:lengths[i] - 1] = rng.randint(3, 12, size=lengths[i] - 2)
        ids[i, lengths[i] - 1] = 2
    situations = rng.rand(batch, 5, 5, 8).astype(np.float32)
    positions = np.zeros((batch,), np.int32)
    return (jcfg, ModelConfig(**kwargs), jparams,
            params_from_numpy(tree, device="cpu"),
            (ids, lengths, situations, positions))


@pytest.mark.parametrize("decode_impl", DECODE_IMPLS)
def test_small_decode_matches_jax(small, decode_impl):
    jcfg, tcfg, jparams, tparams, inputs = small
    ref = jax_decoder(jcfg, max_decoding_steps=20, early_exit=True,
                      exit_check_every=8, decode_impl="xla",
                      compute_dtype="float32")(
        jparams, *(jnp.asarray(a) for a in inputs))
    out = make_greedy_decoder(tcfg, 20, exit_check_every=8,
                              decode_impl=decode_impl)(
        tparams, *(torch.from_numpy(a) for a in inputs))
    assert out.tokens.shape == (7, 21)
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(out.emitted_mask.numpy(),
                                  np.asarray(ref.emitted_mask))
    emitted = np.asarray(ref.emitted_mask) > 0
    np.testing.assert_array_equal(out.tokens.numpy() * emitted,
                                  np.asarray(ref.tokens) * emitted)
    np.testing.assert_allclose(
        out.attention_situations.numpy() * emitted[..., None],
        np.asarray(ref.attention_situations) * emitted[..., None],
        rtol=1e-5, atol=1e-6)
    assert (out.top2_gap is not None) == (decode_impl == "block_plain")


def test_decoder_rejects_unknown_impl_and_bad_tokens(small):
    _, tcfg, _, tparams, (ids, lengths, situations, positions) = small
    with pytest.raises(ValueError):
        make_greedy_decoder(tcfg, 20, decode_impl="xla")
    bad = ids.copy()
    bad[0, 1] = tparams.encoder.embedding.shape[0]
    with pytest.raises(ValueError):
        make_greedy_decoder(tcfg, 20)(
            tparams, torch.from_numpy(bad), torch.from_numpy(lengths),
            torch.from_numpy(situations), torch.from_numpy(positions))
