"""The port's training path equals the JAX package's, on the CPU.

- One whole ``train_step`` of the port (``teacher_forced_impl`` "fused" and
  "step", dropout rates 0, the auxiliary task off and on) against JAX
  ``train_step_body`` from identical params and Adam state, on one batch
  with a padded row. Bars: loss rtol 1e-5; gradients rtol 3e-4 / atol 3e-5
  (tests/test_pallas_teacher_forced.py:149-154); updated params, mu and nu
  atol 1e-6; both counts equal. The Adam state is a random non-zero one
  (count 7): from a zero state the first update is g / (|g| + 1e-8), whose
  value for a gradient near 1e-8 turns on float32 rounding, so an atol on
  the params would test the rounding rather than the port.
- The fixture checkpoint's Adam state resumes with step 200000, and one
  update equals optax's.
- Shuffled batches equal the JAX loader's for one numpy seed.
- Dropout keeps 1 - p of the values, scaled by 1 / (1 - p).
- The JAX package's ``load_checkpoint`` reads a checkpoint the port wrote,
  leaf for leaf; the port re-encodes the fixture checkpoint byte for byte.
- ``init_model_params`` gives JAX's shapes and distributions' supports.
- ``make_eval_forward`` gives JAX's eval loss and metrics.
- ``train`` (streamed, ``steps_per_execution=1``) resumes from the
  fixture, steps, evaluates and checkpoints; the resident trainer is its
  default, as in JAX.
"""

import inspect
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_seq2seq_gscan_tpu.core.batch import Batch as JaxBatch
from multimodal_seq2seq_gscan_tpu.data.dataset import (
    GroundedScanDataset as JaxDataset)
from multimodal_seq2seq_gscan_tpu.models import ModelConfig as JaxConfig
from multimodal_seq2seq_gscan_tpu.models import init_model_params
from multimodal_seq2seq_gscan_tpu.train import checkpoint as jax_ckpt
from multimodal_seq2seq_gscan_tpu.train.state import (
    TrainState as JaxState)
from multimodal_seq2seq_gscan_tpu.train.state import (
    create_train_state as jax_create_state)
from multimodal_seq2seq_gscan_tpu.train.state import make_optimizer
from multimodal_seq2seq_gscan_tpu.train.step import (
    loss_fn as jax_loss_fn)
from multimodal_seq2seq_gscan_tpu.train.step import (
    make_eval_forward as jax_eval_forward)
from multimodal_seq2seq_gscan_tpu.train.step import train_step_body
from multimodal_seq2seq_gscan_tpu_torch.core.batch import Batch
from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
    GroundedScanDataset)
from multimodal_seq2seq_gscan_tpu_torch.models import model as torch_model
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.nn import dropout
from multimodal_seq2seq_gscan_tpu_torch.models.params import (
    count_parameters, init_model_params as torch_init, leaves,
    params_from_numpy)
from multimodal_seq2seq_gscan_tpu_torch.train import checkpoint as ckpt
from multimodal_seq2seq_gscan_tpu_torch.train.loop import train
from multimodal_seq2seq_gscan_tpu_torch.train.state import (
    Adam, AdamState, TrainState, create_train_state)
from multimodal_seq2seq_gscan_tpu_torch.train.step import (
    loss_and_grads, make_eval_forward, train_step)
from multimodal_seq2seq_gscan_tpu_torch.utils import msgpack_lite

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "data",
                       "bench_fixture")
CHECKPOINT = os.path.join(FIXTURE, "model_best.msgpack")
BATCH, T_IN, T_OUT, GRID, CH, V_IN = 6, 7, 13, 5, 8, 12


def tiny_kwargs(**overrides):
    kwargs = dict(input_vocabulary_size=V_IN, target_vocabulary_size=9,
                  num_cnn_channels=CH, embedding_dimension=8,
                  encoder_hidden_size=12, decoder_hidden_size=12,
                  cnn_kernel_size=3, cnn_hidden_num_channels=6)
    kwargs.update(overrides)
    return kwargs


def to_torch(tree):
    return params_from_numpy(flax.serialization.to_state_dict(tree),
                             device="cpu")


def random_batch(seed):
    """Five examples and one all-pad row (as ``pad_to_full_batch`` adds)."""
    rng = np.random.RandomState(seed)
    input_lengths = rng.randint(3, T_IN + 1, size=BATCH).astype(np.int32)
    input_ids = np.zeros((BATCH, T_IN), np.int32)
    targets = np.zeros((BATCH, T_OUT), np.int32)
    target_lengths = np.zeros(BATCH, np.int32)
    for i in range(BATCH - 1):
        input_ids[i, :input_lengths[i]] = rng.randint(1, V_IN,
                                                      size=input_lengths[i])
        n = rng.randint(4, T_OUT)
        targets[i, 0] = 1
        targets[i, 1:n - 1] = rng.randint(3, 9, size=n - 2)
        targets[i, n - 1] = 2
        target_lengths[i] = n
    input_lengths[-1] = 0
    arrays = dict(
        input_ids=input_ids, input_lengths=input_lengths,
        situations=rng.rand(BATCH, GRID, GRID, CH).astype(np.float32),
        target_ids=targets, target_lengths=target_lengths,
        agent_positions=rng.randint(0, GRID * GRID, BATCH).astype(np.int32),
        target_positions=rng.randint(0, GRID * GRID,
                                     BATCH).astype(np.int32))
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            Batch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def random_opt_state(params, count, seed):
    """A non-zero Adam state of ``count`` steps for a JAX params tree."""
    rng = np.random.RandomState(seed)
    mu = jax.tree.map(lambda p: jnp.asarray(
        rng.randn(*p.shape).astype(np.float32) * 1e-3), params)
    nu = jax.tree.map(lambda p: jnp.asarray(
        rng.uniform(1e-6, 1e-5, p.shape).astype(np.float32)), params)
    adam, schedule = make_optimizer().init(params)
    return (adam._replace(count=jnp.int32(count), mu=mu, nu=nu),
            schedule._replace(count=jnp.int32(count)))


@pytest.mark.parametrize("aux", [False, True])
@pytest.mark.parametrize("impl", ["fused", "step"])
def test_train_step_matches_jax(impl, aux):
    kwargs = tiny_kwargs(encoder_dropout_p=0.0, decoder_dropout_p=0.0,
                         cnn_dropout_p=0.0, auxiliary_task=aux)
    jax_config = JaxConfig(**kwargs)
    config = ModelConfig(teacher_forced_impl=impl, **kwargs)
    params = init_model_params(jax.random.PRNGKey(5), jax_config)
    opt_state = random_opt_state(params, 7, seed=3)
    jax_batch, batch = random_batch(11)
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

    (new_state, metrics), loss, grads = reference(state, jax_batch)

    port_state = TrainState(
        step=7, params=to_torch(params),
        opt_state=AdamState(7, to_torch(opt_state[0].mu),
                            to_torch(opt_state[0].nu), 7),
        rng=np.asarray(state.rng))
    port_loss, _, port_grads = loss_and_grads(port_state, batch, config)
    new_port, port_metrics = train_step(port_state, batch, config, Adam())

    np.testing.assert_allclose(float(port_loss), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(port_metrics["loss"]), float(loss),
                               rtol=1e-5)
    for name in ("accuracy", "exact_match", "aux_accuracy"):
        np.testing.assert_allclose(float(port_metrics[name]),
                                   float(metrics[name]), atol=1e-4,
                                   err_msg=name)
    assert len(leaves(port_grads)) == len(jax.tree.leaves(grads)) == 32
    for port, ref in zip(leaves(port_grads), jax.tree.leaves(grads)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=3e-4,
                                   atol=3e-5)
    pairs = [(new_port.params, new_state.params),
             (new_port.opt_state.mu, new_state.opt_state[0].mu),
             (new_port.opt_state.nu, new_state.opt_state[0].nu)]
    for port_tree, ref_tree in pairs:
        port_leaves, ref_leaves = leaves(port_tree), jax.tree.leaves(ref_tree)
        assert len(port_leaves) == len(ref_leaves)
        for port, ref in zip(port_leaves, ref_leaves):
            np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                       rtol=0, atol=1e-6)
    assert new_port.step == int(new_state.step) == 8
    assert new_port.opt_state.count == int(new_state.opt_state[0].count) == 8
    assert new_port.opt_state.schedule_count \
        == int(new_state.opt_state[1].count) == 8


def test_eval_forward_matches_jax():
    """The teacher-forced eval forward (no dropout, default rates on)."""
    kwargs = tiny_kwargs()
    params = init_model_params(jax.random.PRNGKey(8), JaxConfig(**kwargs))
    jax_batch, batch = random_batch(6)
    ref = jax_eval_forward(JaxConfig(**kwargs))(params, jax_batch)
    got = make_eval_forward(ModelConfig(**kwargs))(to_torch(params), batch)
    assert sorted(got) == sorted(ref)
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                               rtol=1e-5)
    for name in ("accuracy", "exact_match"):
        np.testing.assert_allclose(float(got[name]), float(ref[name]),
                                   atol=1e-4)


def test_resumed_adam_state_matches_optax():
    """The fixture's optimizer state carries over (step 200000), and one
    update with the same gradients equals optax's."""
    state, meta = ckpt.load_checkpoint(CHECKPOINT, device="cpu")
    assert state.step == state.opt_state.count == 200000
    assert state.opt_state.schedule_count == 200000
    assert meta["iteration"] == 200000
    with open(CHECKPOINT, "rb") as f:
        ref = flax.serialization.msgpack_restore(f.read())
    template = jax.eval_shape(lambda key: init_model_params(
        key, JaxConfig(input_vocabulary_size=20, target_vocabulary_size=9,
                       num_cnn_channels=16)), jax.random.PRNGKey(0))
    params = flax.serialization.from_state_dict(template, ref["params"])
    mu = flax.serialization.from_state_dict(template,
                                            ref["opt_state"]["0"]["mu"])
    nu = flax.serialization.from_state_dict(template,
                                            ref["opt_state"]["0"]["nu"])
    for port, want in zip(leaves(state.opt_state.mu) + leaves(
            state.opt_state.nu), jax.tree.leaves(mu) + jax.tree.leaves(nu)):
        assert port.numpy().tobytes() == np.asarray(want).tobytes()
    np.testing.assert_array_equal(state.rng, ref["rng"])

    rng = np.random.RandomState(0)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.randn(*p.shape).astype(np.float32) * 1e-2), params)
    optimizer = make_optimizer()
    opt_state = optimizer.init(params)
    opt_state = (opt_state[0]._replace(count=jnp.int32(200000), mu=mu, nu=nu),
                 opt_state[1]._replace(count=jnp.int32(200000)))
    updates, new_opt = optimizer.update(grads, opt_state, params)
    new_params = optax.apply_updates(params, updates)
    port_params, port_opt = Adam().apply(state.params, to_torch(grads),
                                         state.opt_state)
    for port, want in zip(leaves(port_params), jax.tree.leaves(new_params)):
        np.testing.assert_allclose(port.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    assert port_opt.count == int(new_opt[0].count) == 200001
    assert port_opt.schedule_count == int(new_opt[1].count) == 200001


def test_shuffled_batches_identical_to_jax_loader():
    jax_data = JaxDataset(
        os.path.join(FIXTURE, "dataset.txt"), FIXTURE, k=0, split="train",
        input_vocabulary_file="training_input_vocab.txt",
        target_vocabulary_file="training_target_vocab.txt",
        generate_vocabulary=False)
    jax_data.read_dataset()
    port_data = GroundedScanDataset(os.path.join(FIXTURE, "dataset.txt"),
                                    FIXTURE, split="train")
    port_data.read_dataset()
    jax_rng, port_rng = np.random.default_rng(42), np.random.default_rng(42)
    for _ in range(2):  # two epochs from one generator
        jax_data.shuffle_data(jax_rng, bucket_by_length_with_batch_size=200)
        port_data.shuffle_data(port_rng,
                               bucket_by_length_with_batch_size=200)
        ref = list(jax_data.get_data_iterator(
            batch_size=200, pad_to_full_batch=True,
            with_representations=False))
        got = list(port_data.get_data_iterator(batch_size=200,
                                               pad_to_full_batch=True))
        assert len(got) == len(ref) == 3
        for (batch, idx, _, _), (ref_batch, ref_idx, _, _) in zip(got, ref):
            np.testing.assert_array_equal(idx, ref_idx)
            for name in Batch._fields:
                np.testing.assert_array_equal(
                    getattr(batch, name).numpy(),
                    np.asarray(getattr(ref_batch, name)), err_msg=name)


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_dropout_statistics(rate):
    x = torch.full((400000,), 2.0)
    gen = torch.Generator().manual_seed(0)
    y = dropout(gen, x, rate, deterministic=False)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept],
                                                        2.0 / (1 - rate)))
    assert torch.equal(dropout(gen, x, rate, deterministic=True), x)
    assert torch.equal(dropout(gen, x, 0.0, deterministic=False), x)
    config = ModelConfig(**tiny_kwargs(decoder_dropout_p=rate))
    mask = torch_model.decoder_drop_mask(config, (50, 40, 100), "cpu", gen,
                                         deterministic=False)
    assert abs((mask > 0).float().mean().item() - (1 - rate)) < 0.005
    scale = float(np.float32(1.0) / np.float32(1 - rate))
    assert set(mask.unique().tolist()) == {0.0, scale}


def test_dropout_masks_follow_state_seed_and_step():
    """One state gives bit-identical steps; another step draws other masks,
    and the masks change the loss."""
    config = ModelConfig(**tiny_kwargs())
    state = create_train_state(3, config, Adam(), device="cpu")
    _, batch = random_batch(2)
    first, _, _ = loss_and_grads(state, batch, config)
    again, _, _ = loss_and_grads(state, batch, config)
    later, _, _ = loss_and_grads(state._replace(step=1), batch, config)
    assert torch.equal(first, again)
    assert not torch.equal(first, later)


def test_jax_reads_port_checkpoint(tmp_path):
    kwargs = tiny_kwargs()
    config = ModelConfig(**kwargs)
    optimizer = Adam()
    state = create_train_state(0, config, optimizer, device="cpu")
    _, batch = random_batch(4)
    for _ in range(2):
        state, _ = train_step(state, batch, config, optimizer)
    path = ckpt.save_checkpoint(str(tmp_path), state, is_best=True,
                                best_iteration=2, best_accuracy=50.0,
                                best_exact_match=25.0)
    template = jax_create_state(jax.random.PRNGKey(0), JaxConfig(**kwargs),
                                make_optimizer())
    restored, meta = jax_ckpt.load_checkpoint(path, template)
    assert meta == {"iteration": 2, "best_iteration": 2,
                    "best_accuracy": 50.0, "best_exact_match": 25.0}
    opt = state.opt_state
    port_leaves = ([np.int32(state.step)]
                   + [p.numpy() for p in leaves(state.params)]
                   + [np.int32(opt.count)]
                   + [p.numpy() for p in leaves(opt.mu) + leaves(opt.nu)]
                   + [np.int32(opt.schedule_count), state.rng])
    ref_leaves = jax.tree.leaves(restored)
    assert len(port_leaves) == len(ref_leaves)
    for port, ref in zip(port_leaves, ref_leaves):
        ref = np.asarray(ref)
        assert port.dtype == ref.dtype and port.shape == ref.shape
        assert port.tobytes() == ref.tobytes()
    assert os.path.isfile(os.path.join(str(tmp_path), "model_best.msgpack"))
    restored_port, _ = ckpt.load_checkpoint(path, device="cpu")
    for port, ref in zip(leaves(restored_port.params), leaves(state.params)):
        assert torch.equal(port, ref)


def test_fixture_checkpoint_reencodes_byte_for_byte():
    with open(CHECKPOINT, "rb") as f:
        raw = f.read()
    state, _ = ckpt.load_checkpoint(CHECKPOINT, device="cpu")
    assert msgpack_lite.packb(ckpt.state_to_numpy(state)) == raw


def test_init_matches_jax_shapes_and_supports():
    kwargs = tiny_kwargs()
    config = ModelConfig(**kwargs)
    params = torch_init(config, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.eval_shape(lambda key: init_model_params(
        key, JaxConfig(**kwargs)), jax.random.PRNGKey(0))
    ref = jax.tree.leaves(shapes)
    assert [tuple(p.shape) for p in leaves(params)] \
        == [tuple(s.shape) for s in ref]
    assert count_parameters(params) == sum(s.size for s in ref)
    assert torch.all(params.decoder.embedding[0] == 0)
    assert torch.all(params.encoder.embedding[0] == 0)
    bound = 1.0 / np.sqrt(12)
    for w in leaves(params.decoder.lstm_layers):
        assert w.abs().max() <= bound
    assert params.enc_to_dec_w.abs().max() <= bound


def test_train_resumes_steps_evaluates_and_checkpoints(tmp_path):
    events = []
    state, config = train(
        os.path.join(FIXTURE, "dataset.txt"), FIXTURE,
        training_batch_size=8, max_training_examples=16,
        max_testing_examples=8, resume_from_file=CHECKPOINT,
        max_training_iterations=200002, print_every=1,
        evaluate_every=200002, output_directory=str(tmp_path),
        evaluation_batch_size=8, steps_per_execution=1, device="cpu",
        callback=lambda *event: events.append(event))
    assert state.step == 200003
    assert [e[:2] for e in events] == [("train", 200000), ("train", 200001),
                                       ("train", 200002), ("eval", 200002)]
    assert all(np.isfinite(e[2]["loss"]) for e in events[:3])
    assert events[-1][2]["exact_match"] > 50.0
    written, meta = ckpt.load_checkpoint(
        os.path.join(str(tmp_path), "checkpoint.msgpack"), device="cpu")
    assert written.step == meta["iteration"] == 200003
    for port, ref in zip(leaves(written.params), leaves(state.params)):
        assert torch.equal(port, ref)
    # The resident trainer is the default, as in JAX (its own tests:
    # tests/test_torch_resident.py); the run above asked for the streamed
    # path.
    assert inspect.signature(train).parameters[
        "steps_per_execution"].default == 50


@pytest.mark.parametrize("entry", ["train_step", "eval_forward", "decode"])
def test_entry_points_run_in_full_float32(entry, monkeypatch):
    """The entry points turn TF32 off for matmuls and cuDNN while they run,
    whatever the caller's flags, and give the caller's flags back."""
    from multimodal_seq2seq_gscan_tpu_torch.decode import greedy
    config = ModelConfig(**tiny_kwargs())
    state = create_train_state(3, config, Adam(), device="cpu")
    _, batch = random_batch(4)
    seen = []

    def spy(module):
        inner = module.encode_input

        def encode_input(*args, **kwargs):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            return inner(*args, **kwargs)
        monkeypatch.setattr(module, "encode_input", encode_input)

    spy(torch_model)
    spy(greedy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    if entry == "train_step":
        train_step(state, batch, config, Adam())
    elif entry == "eval_forward":
        make_eval_forward(config)(state.params, batch)
    else:
        greedy.make_greedy_decoder(config, 4, decode_impl="step")(
            state.params, batch.input_ids, batch.input_lengths,
            batch.situations, batch.target_positions)
    assert seen and all(flags == (False, False) for flags in seen)
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
