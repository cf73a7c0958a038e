"""The port's resident trainer (``train/resident.py``) equals the JAX
package's, on the CPU.

- The numpy index streams give JAX's blocks and segment specs for the same
  seeds: the full layout, and the stratified one with cuts, with
  ``wide_mix``, with ``interleave`` and with classes of multiples of 16;
  the degenerate ``wide_mix`` falls back with JAX's warning, the progress
  guard raises, and ``resolve_chunk_size`` agrees.
- The packed columns and ``gather_batch`` equal JAX's on the fixture.
- A CPU chunk of K steps equals K of the port's single steps, dropout on
  (the same arithmetic: bit for bit).
- A CPU chunk equals JAX's ``make_train_chunk``, dropout 0, with and
  without segments, at the JAX chunk test's bars (losses rtol 2e-5, params
  and moments rtol 2e-5 / atol 1e-6), from a random non-zero Adam state
  (tests/test_torch_train.py says why).
- ``train(steps_per_execution=4)`` (a misaligned start, chunks, a tail of
  single steps) equals JAX's ``train``, dropout 0: the logged losses and
  the final params.
- ``train(profile_dir=...)`` writes a trace.
"""

import json
import logging
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_seq2seq_gscan_tpu.data.dataset import (
    GroundedScanDataset as JaxDataset)
from multimodal_seq2seq_gscan_tpu.models import ModelConfig as JaxConfig
from multimodal_seq2seq_gscan_tpu.models import init_model_params
from multimodal_seq2seq_gscan_tpu.train import checkpoint as jax_ckpt
from multimodal_seq2seq_gscan_tpu.train import resident as jax_resident
from multimodal_seq2seq_gscan_tpu.train.loop import train as jax_train
from multimodal_seq2seq_gscan_tpu.train.state import (
    TrainState as JaxState)
from multimodal_seq2seq_gscan_tpu.train.state import make_optimizer
from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
    GroundedScanDataset)
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.params import leaves
from multimodal_seq2seq_gscan_tpu_torch.train import loop as port_loop
from multimodal_seq2seq_gscan_tpu_torch.train import resident
from multimodal_seq2seq_gscan_tpu_torch.train.loop import train
from multimodal_seq2seq_gscan_tpu_torch.train.state import (
    Adam, AdamState, TrainState)
from multimodal_seq2seq_gscan_tpu_torch.train.step import train_step
from tests.test_torch_train import random_opt_state, tiny_kwargs, to_torch

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "data",
                       "bench_fixture")
DATASET = os.path.join(FIXTURE, "dataset.txt")


def skewed_lengths(seed, n_short=90, n_long=30):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.randint(3, 33, n_short),
                           rng.randint(33, 80, n_long)]).astype(np.int32)


STRATIFIED = {
    "cuts": dict(cuts=(32,)),
    "wide_mix": dict(cuts=(32,), wide_mix=0.5),
    "interleave": dict(cuts=(16, 32), interleave=True),
    "x16": dict(width_multiple=16),
}


@pytest.mark.parametrize("layout", ["full"] + sorted(STRATIFIED))
def test_index_streams_equal_jax(layout):
    lengths = skewed_lengths(4)
    batch, k = 8, 6
    if layout == "full":
        ours = resident.index_block_stream(len(lengths), batch, k,
                                           np.random.default_rng(3))
        ref = jax_resident.index_block_stream(len(lengths), batch, k,
                                              np.random.default_rng(3))
        pairs = [(next(ours), next(ref)) for _ in range(12)]
    else:
        options = STRATIFIED[layout]
        ours = resident.stratified_index_block_stream(
            lengths, batch, k, np.random.default_rng(3), **options)
        ref = jax_resident.stratified_index_block_stream(
            lengths, batch, k, np.random.default_rng(3), **options)
        pairs = []
        for _ in range(12):
            (block, spec), (ref_block, ref_spec) = next(ours), next(ref)
            assert spec == ref_spec
            pairs.append((block, ref_block))
        assert resident.chunk_segment_spec(lengths, 50, **options) \
            == jax_resident.chunk_segment_spec(lengths, 50, **options)
    for block, ref_block in pairs:
        assert block.dtype == ref_block.dtype == np.int32
        np.testing.assert_array_equal(block, ref_block)


def test_degenerate_wide_mix_falls_back_as_jax():
    lengths = np.concatenate([np.random.RandomState(17).randint(3, 9, 90),
                              np.random.RandomState(18).randint(9, 20, 10)]
                             ).astype(np.int32)
    with pytest.warns(RuntimeWarning, match="disabling wide_mix"):
        spec = resident.chunk_segment_spec(lengths, 1, cuts=(8,),
                                           wide_mix=0.5)
    with pytest.warns(RuntimeWarning, match="disabling wide_mix"):
        ref = jax_resident.chunk_segment_spec(lengths, 1, cuts=(8,),
                                              wide_mix=0.5)
    assert spec == ref and max(w for _, w in spec) >= int(lengths.max())
    with pytest.warns(RuntimeWarning, match="disabling wide_mix"):
        block, got = next(resident.stratified_index_block_stream(
            lengths, 8, 1, np.random.default_rng(5), cuts=(8,),
            wide_mix=0.5))
    with pytest.warns(RuntimeWarning, match="disabling wide_mix"):
        ref_block, _ = next(jax_resident.stratified_index_block_stream(
            lengths, 8, 1, np.random.default_rng(5), cuts=(8,),
            wide_mix=0.5))
    assert got == spec
    np.testing.assert_array_equal(block, ref_block)


def test_progress_guard_raises(monkeypatch):
    lengths = np.random.RandomState(19).randint(9, 17, 100).astype(np.int32)
    monkeypatch.setattr(resident, "chunk_segment_spec",
                        lambda *a, **k: ((5, 8),))
    stream = resident.stratified_index_block_stream(
        lengths, 4, 5, np.random.default_rng(6), width_multiple=16)
    with pytest.raises(RuntimeError, match="no progress over two"):
        next(stream)


def test_resolve_chunk_size_equals_jax():
    for args in ((50, 500, 4000), (64, 500, 4000), (50, 10, 20),
                 (7, 500, 4000), (1, 500, 4000), (1000, 500, 4000),
                 (50, 2, 3)):
        assert resident.resolve_chunk_size(*args) \
            == jax_resident.resolve_chunk_size(*args)


def fixture_sets(n=16):
    jax_set = JaxDataset(DATASET, FIXTURE, k=0, split="train",
                         input_vocabulary_file="training_input_vocab.txt",
                         target_vocabulary_file="training_target_vocab.txt")
    jax_set.read_dataset(max_examples=n)
    port_set = GroundedScanDataset(DATASET, FIXTURE, split="train")
    port_set.read_dataset(max_examples=n)
    return jax_set, port_set


def test_packed_columns_and_gather_equal_jax():
    jax_set, port_set = fixture_sets()
    host = resident.host_resident_data(port_set)
    ref_host = jax_resident.host_resident_data(jax_set)
    for name, got, want in zip(resident.ResidentData._fields, host,
                               ref_host):
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    data = resident.build_resident_data(port_set, "cpu")
    assert data.nbytes == sum(a.nbytes for a in ref_host)
    idx = np.random.default_rng(1).permutation(16)[:8].astype(np.int32)
    got = resident.gather_batch(data, idx)
    want = jax_resident.gather_batch(ref_host, idx)
    for name in got._fields:
        ours, theirs = getattr(got, name).numpy(), np.asarray(
            getattr(want, name))
        assert ours.dtype == theirs.dtype, name
        np.testing.assert_array_equal(ours, theirs, err_msg=name)


def toy_problem():
    """The JAX resident tests' toy split (24 examples, a 4x4 grid)."""
    host = jax_resident.ResidentData(
        *(np.asarray(a) for a in _jax_toy_host()))
    return host, resident.ResidentData(*(torch.from_numpy(
        np.ascontiguousarray(a)) for a in host))


def _jax_toy_host(n=24, grid=4, channels=6, t_in=7, t_out=9):
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
    return (input_ids, input_lengths,
            (rng.rand(n, grid, grid, channels) < 0.2).astype(np.uint8),
            target_ids, target_lengths,
            rng.randint(0, grid * grid, size=n).astype(np.int32),
            rng.randint(0, grid * grid, size=n).astype(np.int32))


def toy_kwargs(**overrides):
    kwargs = dict(input_vocabulary_size=12, target_vocabulary_size=8,
                  num_cnn_channels=6, embedding_dimension=10,
                  encoder_hidden_size=12, decoder_hidden_size=12,
                  cnn_kernel_size=3, cnn_hidden_num_channels=6,
                  auxiliary_task=True)
    kwargs.update(overrides)
    return kwargs


def states(kwargs, seed=7):
    """The same state for both packages: JAX-initialised params, a random
    non-zero Adam state of 7 steps, step 7."""
    jax_config = JaxConfig(**kwargs)
    params = init_model_params(jax.random.PRNGKey(seed), jax_config)
    opt_state = random_opt_state(params, 7, seed=3)
    jax_state = JaxState(step=jnp.int32(7), params=params,
                         opt_state=opt_state, rng=jax.random.PRNGKey(1))
    port_state = TrainState(
        step=7, params=to_torch(params),
        opt_state=AdamState(7, to_torch(opt_state[0].mu),
                            to_torch(opt_state[0].nu), 7),
        rng=np.asarray(jax_state.rng))
    return jax_config, jax_state, port_state


def assert_trees_close(port_tree, jax_tree, rtol, atol):
    port_leaves, ref_leaves = leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(port_leaves) == len(ref_leaves)
    for port, ref in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol,
                                   atol=atol)


def test_cpu_chunk_equals_single_steps_with_dropout():
    _, data = toy_problem()
    config = ModelConfig(**toy_kwargs())
    _, _, state = states(toy_kwargs())
    block = next(resident.index_block_stream(24, 8, 4,
                                             np.random.default_rng(3)))
    chunk = resident.make_train_chunk(config, Adam())
    chunked, metrics = chunk(state, data, block)
    assert all(v.shape == (4,) for v in metrics.values())
    single = state
    for k, row in enumerate(block):
        single, m = train_step(single, resident.gather_batch(data, row),
                               config, Adam())
        for name, value in m.items():
            assert torch.equal(metrics[name][k], value), name
    assert chunked.step == single.step == 11
    assert chunked.opt_state[0::3] == single.opt_state[0::3] == (11, 11)
    for tree in ("params",):
        for a, b in zip(leaves(getattr(chunked, tree)),
                        leaves(getattr(single, tree))):
            assert torch.equal(a, b)
    for a, b in zip(leaves(chunked.opt_state.mu) + leaves(
            chunked.opt_state.nu), leaves(single.opt_state.mu) + leaves(
            single.opt_state.nu)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("segmented", [False, True])
def test_cpu_chunk_equals_jax_chunk(segmented):
    host, data = toy_problem()
    kwargs = toy_kwargs(encoder_dropout_p=0.0, decoder_dropout_p=0.0,
                        cnn_dropout_p=0.0)
    jax_config, jax_state, port_state = states(kwargs)
    k, batch = 4, 8
    w_max = int(host.target_lengths.max())
    segments = None
    if segmented:
        rng = np.random.default_rng(6)
        short_rows = np.flatnonzero(host.target_lengths <= w_max - 1)
        block = np.stack(
            [rng.choice(24, batch, replace=False) for _ in range(2)]
            + [rng.choice(short_rows, batch, replace=False)
               for _ in range(2)]).astype(np.int32)
        segments = ((2, w_max), (2, w_max - 1))
    else:
        block = next(resident.index_block_stream(24, batch, k,
                                                 np.random.default_rng(3)))
    ref_chunk = jax_resident.make_train_chunk(jax_config, make_optimizer(),
                                              donate=False)
    ref_state, ref_metrics = ref_chunk(
        jax_state, jax_resident.ResidentData(*(jax.device_put(a)
                                               for a in host)),
        block, segments)
    chunk = resident.make_train_chunk(ModelConfig(**kwargs), Adam())
    state, metrics = chunk(port_state, data, block, segments)
    for name in resident.METRIC_NAMES:
        np.testing.assert_allclose(metrics[name].numpy(),
                                   np.asarray(ref_metrics[name]),
                                   rtol=2e-5, atol=1e-4 if name != "loss"
                                   else 0, err_msg=name)
    assert_trees_close(state.params, ref_state.params, 2e-5, 1e-6)
    assert_trees_close(state.opt_state.mu, ref_state.opt_state[0].mu, 2e-5,
                       1e-6)
    assert_trees_close(state.opt_state.nu, ref_state.opt_state[0].nu, 2e-5,
                       1e-6)
    assert state.step == int(ref_state.step) == 11
    assert state.opt_state.count == int(ref_state.opt_state[0].count) == 11


TRAIN_KWARGS = dict(
    embedding_dimension=8, num_encoder_layers=1, encoder_dropout_p=0.0,
    encoder_bidirectional=True, training_batch_size=4,
    max_decoding_steps=20, num_decoder_layers=1, decoder_dropout_p=0.0,
    cnn_kernel_size=3, cnn_dropout_p=0.0, cnn_hidden_num_channels=6,
    decoder_hidden_size=12, encoder_hidden_size=12, learning_rate=0.001,
    adam_beta_1=0.9, adam_beta_2=0.999, lr_decay=0.9, lr_decay_steps=20000,
    print_every=4, evaluate_every=1000, conditional_attention=True,
    auxiliary_task=False, weight_target_loss=0.3, attention_type="bahdanau",
    k=0, max_training_examples=16, max_testing_examples=8,
    evaluation_batch_size=8, seed=42, steps_per_execution=4)


def test_resident_train_equals_jax(tmp_path, caplog):
    """From one checkpoint at step 7: two single steps (to the chunk grid),
    two chunks of 4 and a tail of 2 single steps (iterations 7 to 18),
    logged at 8, 12 and 16."""
    train_set = GroundedScanDataset(DATASET, FIXTURE, split="train")
    train_set.read_dataset(max_examples=16)
    kwargs = dict(input_vocabulary_size=train_set.input_vocabulary_size,
                  target_vocabulary_size=train_set.target_vocabulary_size,
                  num_cnn_channels=train_set.image_channels,
                  embedding_dimension=8, encoder_hidden_size=12,
                  decoder_hidden_size=12, cnn_kernel_size=3,
                  cnn_hidden_num_channels=6)
    _, jax_state, _ = states(kwargs)
    start = str(tmp_path / "start")
    path = jax_ckpt.save_checkpoint(start, jax_state)
    with caplog.at_level(logging.INFO):
        ref_state, _ = jax_train(
            DATASET, FIXTURE, generate_vocabularies=False,
            input_vocab_path="training_input_vocab.txt",
            target_vocab_path="training_target_vocab.txt",
            test_batch_size=8, simple_situation_representation=True,
            resume_from_file=path, max_training_iterations=18,
            output_directory=str(tmp_path / "jax"), **TRAIN_KWARGS)
    ref_losses = [float(x) for x in re.findall(
        r"Iteration 000000(?:08|12|16), loss +([0-9.]+)", caplog.text)]
    events = []
    state, _ = train(DATASET, FIXTURE, resume_from_file=path,
                     max_training_iterations=18,
                     output_directory=str(tmp_path / "port"), device="cpu",
                     callback=lambda *event: events.append(event),
                     **TRAIN_KWARGS)
    assert [e[1] for e in events] == [8, 12, 16]
    assert len(ref_losses) == 3
    for (_, _, values), ref in zip(events, ref_losses):
        assert abs(values["loss"] - ref) <= 5.1e-5  # JAX logs 4 decimals
    assert state.step == int(ref_state.step) == 19
    assert_trees_close(state.params, ref_state.params, 2e-5, 1e-6)


def test_profile_dir_writes_a_trace(tmp_path):
    trace_dir = tmp_path / "trace"
    state, _ = train(DATASET, FIXTURE, max_training_iterations=32,
                     output_directory=str(tmp_path / "out"), device="cpu",
                     profile_dir=str(trace_dir),
                     **dict(TRAIN_KWARGS, print_every=8,
                            evaluate_every=1000))
    assert state.step == 32
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("ProfilerStep" in e.get("name", "") or e.get("ph") == "X"
               for e in events)
