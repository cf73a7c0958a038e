"""How the port picks its paths, on the CPU.

- A decoder that is not the flagship one (no conditional attention, or more
  than one layer) runs, as in the JAX package, through the step path: the
  default ``decode_impl`` and ``teacher_forced_impl`` warn and fall back
  (``models.config.decoder_impl``). ``evaluate`` and one ``train_step``
  with ``conditional_attention=False`` then equal JAX's ``evaluate`` and
  ``train_step_body`` at the bars of tests/test_torch_train.py and
  tests/test_torch_greedy.py; a teacher-forced unroll of two decoder layers
  is refused, naming ROADMAP A13.
- ``train`` refuses, by name, each keyword that the port does not honour.
"""

import logging
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_seq2seq_gscan_tpu.data.dataset import (
    GroundedScanDataset as JaxDataset)
from multimodal_seq2seq_gscan_tpu.decode.greedy import (
    make_greedy_decoder as jax_decoder)
from multimodal_seq2seq_gscan_tpu.decode.predict import (
    evaluate as jax_evaluate)
from multimodal_seq2seq_gscan_tpu.models import ModelConfig as JaxConfig
from multimodal_seq2seq_gscan_tpu.models import init_model_params
from multimodal_seq2seq_gscan_tpu.train.state import (
    TrainState as JaxState)
from multimodal_seq2seq_gscan_tpu.train.state import make_optimizer
from multimodal_seq2seq_gscan_tpu.train.step import (
    loss_fn as jax_loss_fn)
from multimodal_seq2seq_gscan_tpu.train.step import train_step_body
from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
    GroundedScanDataset)
from multimodal_seq2seq_gscan_tpu_torch.decode.greedy import (
    make_greedy_decoder)
from multimodal_seq2seq_gscan_tpu_torch.decode.predict import evaluate
from multimodal_seq2seq_gscan_tpu_torch.models import config as config_mod
from multimodal_seq2seq_gscan_tpu_torch.models.config import (
    ModelConfig, decoder_impl)
from multimodal_seq2seq_gscan_tpu_torch.models.params import (
    leaves, params_from_numpy)
from multimodal_seq2seq_gscan_tpu_torch.train.loop import train
from multimodal_seq2seq_gscan_tpu_torch.train.state import (
    Adam, AdamState, TrainState, create_train_state)
from multimodal_seq2seq_gscan_tpu_torch.train.step import (
    loss_and_grads, train_step)
from tests.test_torch_train import (
    random_batch, random_opt_state, tiny_kwargs, to_torch)

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "data",
                       "bench_fixture")
DATASET = os.path.join(FIXTURE, "dataset.txt")


# ---------------------------------------------------------------------------
# C.4: configurations other than the flagship decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,layers,conditional,expected", [
    ("block", 1, True, "block"), ("fused", 1, True, "fused"),
    ("block", 1, False, "step"), ("fused", 1, False, "step"),
    ("plain", 1, False, "step"), ("block_plain", 2, True, "step"),
    ("step", 2, False, "step")])
def test_decoder_impl_rule(caplog, impl, layers, conditional, expected):
    config = ModelConfig(**tiny_kwargs(num_decoder_layers=layers,
                                       conditional_attention=conditional))
    config_mod._warned.clear()
    flag = "decode_impl" if impl.startswith("block") else \
        "teacher_forced_impl"
    with caplog.at_level(logging.WARNING):
        assert decoder_impl(config, impl, flag) == expected
        assert decoder_impl(config, impl, flag) == expected
    warned = [r for r in caplog.records if "falling back" in r.getMessage()]
    assert len(warned) == (impl != expected)  # once, not per call


@pytest.mark.parametrize("impl", ["fused", "plain", "step"])
def test_train_step_without_conditional_attention_matches_jax(impl):
    kwargs = tiny_kwargs(encoder_dropout_p=0.0, decoder_dropout_p=0.0,
                         cnn_dropout_p=0.0, conditional_attention=False)
    jax_config = JaxConfig(**kwargs)
    config = ModelConfig(teacher_forced_impl=impl, **kwargs)
    params = init_model_params(jax.random.PRNGKey(9), jax_config)
    opt_state = random_opt_state(params, 7, seed=4)
    jax_batch, batch = random_batch(12)
    state = JaxState(step=jnp.int32(7), params=params, opt_state=opt_state,
                     rng=jax.random.PRNGKey(1))
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
    assert len(leaves(port_grads)) == len(jax.tree.leaves(grads))
    for port, ref in zip(leaves(port_grads), jax.tree.leaves(grads)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=3e-4,
                                   atol=3e-5)
    for port, ref in zip(leaves(new_port.params),
                         jax.tree.leaves(new_state.params)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)


def test_evaluate_without_conditional_attention_matches_jax():
    n = 64
    jax_data = JaxDataset(DATASET, FIXTURE, k=0, split="dev",
                          input_vocabulary_file="training_input_vocab.txt",
                          target_vocabulary_file="training_target_vocab.txt",
                          generate_vocabulary=False)
    jax_data.read_dataset(max_examples=n)
    port_data = GroundedScanDataset(DATASET, FIXTURE, split="dev")
    port_data.read_dataset(max_examples=n)
    kwargs = dict(input_vocabulary_size=port_data.input_vocabulary_size,
                  target_vocabulary_size=port_data.target_vocabulary_size,
                  num_cnn_channels=port_data.image_channels,
                  embedding_dimension=8, encoder_hidden_size=12,
                  decoder_hidden_size=12, cnn_kernel_size=3,
                  cnn_hidden_num_channels=6, conditional_attention=False,
                  auxiliary_task=True)
    jax_params = init_model_params(jax.random.PRNGKey(3), JaxConfig(**kwargs))
    params = params_from_numpy(jax.tree.map(
        np.asarray, flax.serialization.to_state_dict(jax_params)),
        device="cpu")
    ref = jax_evaluate(jax_data, jax_params, JaxConfig(**kwargs), 20,
                       batch_size=32)
    got = evaluate(port_data, params, ModelConfig(**kwargs), 20,
                   batch_size=32, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_two_layer_decoder_decodes_as_jax_and_refuses_teacher_forcing():
    kwargs = tiny_kwargs(num_decoder_layers=2)
    jax_params = init_model_params(jax.random.PRNGKey(4), JaxConfig(**kwargs))
    params = to_torch(jax_params)
    config = ModelConfig(**kwargs)
    jax_batch, batch = random_batch(3)
    inputs = ("input_ids", "input_lengths", "situations", "target_positions")
    ref = jax_decoder(JaxConfig(**kwargs), max_decoding_steps=12,
                      decode_impl="xla", compute_dtype="float32")(
        jax_params, *(getattr(jax_batch, name) for name in inputs))
    out = make_greedy_decoder(config, 12)(
        params, *(getattr(batch, name) for name in inputs))
    np.testing.assert_array_equal(out.emitted_mask.numpy(),
                                  np.asarray(ref.emitted_mask))
    emitted = np.asarray(ref.emitted_mask) > 0
    np.testing.assert_array_equal(out.tokens.numpy() * emitted,
                                  np.asarray(ref.tokens) * emitted)
    state = create_train_state(0, config, Adam(), device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        train_step(state, batch, config, Adam())


# ---------------------------------------------------------------------------
# C.6: keywords of the JAX train that the port does not honour
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keyword,value,error,match", [
    ("simple_situation_representation", False, NotImplementedError,
     "RGB"),
    ("profile_dir", "trace", NotImplementedError, "A12"),
    ("prefetch_depth", 1, NotImplementedError, "A12"),
    ("chunk_layout", "stratified", NotImplementedError, "A9"),
    ("stratified_widths", "16,32", NotImplementedError, "A9"),
    ("k", 1, NotImplementedError, "A14"),
    ("generate_vocabularies", True, NotImplementedError, "A14"),
    ("seeds", "1,2", NotImplementedError, "A10"),
    ("mesh", object(), NotImplementedError, "A11"),
    ("no_such_flag", 1, TypeError, "no_such_flag")])
def test_train_refuses_keywords_it_does_not_honour(tmp_path, keyword, value,
                                                   error, match):
    with pytest.raises(error, match=match):
        train(DATASET, FIXTURE, output_directory=str(tmp_path),
              device="cpu", **{keyword: value})
