"""How the port picks its paths, on the CPU.

- A decoder that is not the flagship one (no conditional attention, or more
  than one layer) runs, as in the JAX package, through the step path: the
  default ``decode_impl`` and ``teacher_forced_impl`` warn and fall back
  (``models.config.decoder_impl``). ``evaluate`` and one ``train_step``
  with ``conditional_attention=False`` then equal JAX's ``evaluate`` and
  ``train_step_body`` at the bars of tests/test_torch_train.py and
  tests/test_torch_greedy.py. A decoder of two layers (and an encoder of
  two) decodes as JAX's, and its teacher-forced unroll, whichever
  ``teacher_forced_impl`` is asked for, takes ``"step"`` and gives JAX's
  ``"xla"`` train step at the same bars, dropout off; with dropout on, the
  inter-layer masks keep 1 - p of the values at scale 1 / (1 - p) and are
  drawn from the step's generator.
- ``train`` refuses, by name, each keyword that the port does not honour
  (``seeds`` with a mesh, as JAX does, a ``mesh`` that is not a
  ``parallel.mesh.Mesh``, by type, and under a mesh an evaluation batch
  that does not split over the data axis, before the first step), and
  honours those it took since (the resident trainer's layouts,
  ``profile_dir``, ``prefetch_depth``, ``k`` under either dataset
  backend, ``generate_vocabularies``).
- The encoder kernel (``ops/encoder_lstm.py``, no backward) runs the
  command's LSTM only on the card without autograd: on CPU tensors, and
  under ``torch.enable_grad()`` with weights that require grad,
  ``encode_input`` runs ``masked_lstm_scan`` and never the kernel's
  wrapper (``encoder_kernel_layers`` stays 0), for 1 and 2 layers, one
  direction or two, and the wrapper refuses inputs that require grad.
  Where the kernel applies, the one wiring loop calls the wrapper once a
  layer with that layer's directions, the directions summed and the hidden
  asked for on the last layer only; with a stand-in for the wrapper that
  runs the scan's layer, its results equal the scan path's, dropout on and
  off. The kernel itself is held on the card
  (tests/test_torch_encoder_kernel.py).
"""

import functools
import logging
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
from multimodal_seq2seq_gscan_tpu_torch.parallel.mesh import Mesh
from multimodal_seq2seq_gscan_tpu_torch.train.loop import train
from multimodal_seq2seq_gscan_tpu_torch.train.state import (
    Adam, AdamState, TrainState, create_train_state)
from multimodal_seq2seq_gscan_tpu_torch.train.step import (
    loss_and_grads, train_step)
from tests.test_torch_train import (
    random_batch, random_opt_state, tiny_kwargs, to_torch)
from tests.test_torch_decode_dtype import one_torch_thread  # noqa: F401

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
    assert_train_step_matches_jax(
        tiny_kwargs(encoder_dropout_p=0.0, decoder_dropout_p=0.0,
                    cnn_dropout_p=0.0, conditional_attention=False),
        impl, params_key=9, opt_seed=4, batch_seed=12)


@pytest.mark.parametrize("impl", ["fused", "plain", "step"])
def test_two_layer_train_step_matches_jax(impl):
    """Two encoder and two decoder layers, dropout off: every impl takes
    the step unroll, and one step equals JAX's scan path."""
    assert_train_step_matches_jax(
        tiny_kwargs(encoder_dropout_p=0.0, decoder_dropout_p=0.0,
                    cnn_dropout_p=0.0, num_encoder_layers=2,
                    num_decoder_layers=2),
        impl, params_key=6, opt_seed=5, batch_seed=13)


def test_inter_layer_dropout_rate_scale_and_generator(monkeypatch):
    """With dropout on, a two-layer encoder and decoder draw their
    inter-layer masks from the step's generator (the same generator state
    gives the same loss, another gives another), each mask keeping about
    1 - p of the values at scale 1 / (1 - p)."""
    from multimodal_seq2seq_gscan_tpu_torch.models import model
    kwargs = tiny_kwargs(encoder_dropout_p=0.3, decoder_dropout_p=0.3,
                         cnn_dropout_p=0.1, num_encoder_layers=2,
                         num_decoder_layers=2)
    config = ModelConfig(**kwargs)
    state = create_train_state(2, config, Adam(), device="cpu")
    _, batch = random_batch(4)
    first, _, _ = loss_and_grads(state, batch, config)
    again, _, _ = loss_and_grads(state, batch, config)
    later, _, _ = loss_and_grads(state._replace(step=1), batch, config)
    assert torch.equal(first, again) and not torch.equal(first, later)

    drawn = []
    dropout = model.dropout

    def spy(generator, x, rate, deterministic):
        out = dropout(generator, x, rate, deterministic)
        drawn.append(("encoder", generator, x, out, rate))
        return out

    masks = model.decoder_drop_mask

    def mask_spy(config, shape, device, generator, deterministic):
        out = masks(config, shape, device, generator, deterministic)
        drawn.append(("decoder", generator, shape, out, None))
        return out

    monkeypatch.setattr(model, "dropout", spy)
    monkeypatch.setattr(model, "decoder_drop_mask", mask_spy)
    generator = torch.Generator().manual_seed(0)
    model.forward(to_torch(init_model_params(jax.random.PRNGKey(1),
                                             JaxConfig(**kwargs))),
                  config, batch.input_ids, batch.input_lengths,
                  batch.situations, batch.target_ids, generator=generator,
                  deterministic=False)
    # CNN features, embedding, one encoder layer's output; the decoder's
    # embedded tokens, then its [T, 1, B, H] inter-layer mask.
    assert [d[0] for d in drawn] == ["encoder"] * 3 + ["decoder"] * 2
    assert all(d[1] is generator for d in drawn)
    layer_in, layer_out = drawn[2][2], drawn[2][3]
    assert layer_in.shape[-1] == 2 * kwargs["encoder_hidden_size"]
    kept = layer_out != 0
    torch.testing.assert_close(layer_out[kept], layer_in[kept] / 0.7)
    layer_mask = drawn[4][3]
    assert tuple(layer_mask.shape) == (batch.target_ids.shape[1], 1,
                                       batch.target_ids.shape[0],
                                       kwargs["decoder_hidden_size"])
    assert set(layer_mask.unique().tolist()) == {
        0.0, float(np.float32(1.0) / np.float32(0.7))}
    big = model.decoder_drop_mask(config, (200, 1, 50, 100), "cpu",
                                  generator, deterministic=False)
    assert abs((big > 0).float().mean().item() - 0.7) < 0.005


@functools.lru_cache(maxsize=None)
def jax_train_step(kwargs, params_key, opt_seed, batch_seed):
    """(state, new state, loss, gradients) of JAX's ``train_step_body`` on
    ``random_batch(batch_seed)``, computed once for every impl of the port
    held to it."""
    jax_config = JaxConfig(**dict(kwargs))
    params = init_model_params(jax.random.PRNGKey(params_key), jax_config)
    opt_state = random_opt_state(params, 7, seed=opt_seed)
    jax_batch, _ = random_batch(batch_seed)
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
    return state, new_state, loss, grads


def assert_train_step_matches_jax(kwargs, impl, params_key, opt_seed,
                                  batch_seed):
    """One port ``train_step`` with ``teacher_forced_impl=impl`` against
    JAX's ``train_step_body`` (its scan path) from identical params and
    Adam state: loss rtol 1e-5, gradients rtol 3e-4 / atol 3e-5, updated
    params atol 1e-6."""
    config = ModelConfig(teacher_forced_impl=impl, **kwargs)
    state, new_state, loss, grads = jax_train_step(
        tuple(sorted(kwargs.items())), params_key, opt_seed, batch_seed)
    params, opt_state = state.params, state.opt_state
    _, batch = random_batch(batch_seed)
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
    """A two-layer decoder decodes as JAX's; its teacher-forced unroll,
    refused until the port had it (ROADMAP A13), now trains: one step equals
    JAX's (``test_two_layer_train_step_matches_jax`` holds it for every
    impl)."""
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
    new_state, metrics = train_step(state, batch, config, Adam())
    assert new_state.step == 1 and bool(torch.isfinite(metrics["loss"]))


# ---------------------------------------------------------------------------
# C.6: keywords of the JAX train that the port does not honour
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keyword,value,error,match", [
    ("simple_situation_representation", False, NotImplementedError,
     "RGB"),
    ("seeds", "1,2", NotImplementedError, "single-chip"),
    ("mesh", object(), TypeError, "Mesh"),
    ("evaluation_batch_size", 3, ValueError,
     "a batch of 3 rows does not split over the 2 ranks"),
    ("no_such_flag", 1, TypeError, "no_such_flag")])
def test_train_refuses_keywords_it_does_not_honour(tmp_path, keyword, value,
                                                   error, match):
    """A campaign (``seeds``) is honoured since ROADMAP A10; with a mesh it
    is refused, as JAX refuses it. Under a mesh an evaluation batch that
    does not split over the data axis is refused at start-up: this mesh
    has no process group, so the refusal comes before the first
    collective, and so before the first step."""
    extra = {}
    if keyword in ("seeds", "evaluation_batch_size"):
        extra["mesh"] = Mesh(None, 0, 2, 2, 1, torch.device("cpu"), "gloo")
    with pytest.raises(error, match=match):
        train(DATASET, FIXTURE, output_directory=str(tmp_path),
              device="cpu", **{keyword: value}, **extra)


@pytest.mark.parametrize("keyword,value", [
    ("profile_dir", "trace"), ("chunk_layout", "stratified"),
    ("stratified_widths", "16,32"), ("prefetch_depth", 1), ("k", 2),
    ("generate_vocabularies", True)])
def test_train_honours_keywords_it_once_refused(tmp_path, monkeypatch,
                                                keyword, value):
    """The resident trainer's layouts, ``profile_dir``, ``prefetch_depth``,
    ``k`` and ``generate_vocabularies``, refused until the port had them,
    are honoured: a stratified layout streams its blocks with the cuts
    asked for, ``profile_dir`` gets a trace, the streamed path prefetches
    that many batches, ``k`` reaches the k-shot move with the run's seed,
    and vocabularies generated from the train split are saved into the
    data directory (here a copy of the fixture's dataset) before the dev
    split loads them."""
    import shutil
    from multimodal_seq2seq_gscan_tpu_torch.data import dataset as data_mod
    from multimodal_seq2seq_gscan_tpu_torch.train import loop
    streams, depths, moves = [], [], []
    stratified = loop.stratified_index_block_stream
    prefetch = loop.prefetch_to_device
    moved_classes = (data_mod.ParsedDataset,
                     data_mod.native_loader.NativeDataset)
    move = {cls: cls.move_k_examples_to_train_and_dev
            for cls in moved_classes}

    def spy(*args, **kwargs):
        streams.append(kwargs)
        return stratified(*args, **kwargs)

    def prefetch_spy(iterator, depth, device):
        depths.append(depth)
        return prefetch(iterator, depth=depth, device=device)

    def move_spy(self, k, rng, split="adverb_1"):
        moves.append((k, rng.random()))
        return move[type(self)](self, k, rng, split)

    monkeypatch.setattr(loop, "stratified_index_block_stream", spy)
    monkeypatch.setattr(loop, "prefetch_to_device", prefetch_spy)
    for cls in moved_classes:  # whichever backend parses
        monkeypatch.setattr(cls, "move_k_examples_to_train_and_dev",
                            move_spy)
    options = {keyword: value, "steps_per_execution": 4}
    data_path, data_directory = DATASET, FIXTURE
    if keyword == "profile_dir":
        options[keyword] = str(tmp_path / value)
    elif keyword == "stratified_widths":
        options["chunk_layout"] = "stratified"
    elif keyword == "prefetch_depth":
        options["steps_per_execution"] = 1
    elif keyword == "generate_vocabularies":
        data_directory = str(tmp_path / "data")
        os.makedirs(data_directory)
        data_path = shutil.copy(DATASET, data_directory)
    state, _ = train(data_path, data_directory,
                     output_directory=str(tmp_path), device="cpu",
                     max_training_examples=16, training_batch_size=4,
                     embedding_dimension=8, encoder_hidden_size=12,
                     decoder_hidden_size=12, cnn_kernel_size=3,
                     cnn_hidden_num_channels=6, print_every=4,
                     evaluate_every=1000, max_training_iterations=32,
                     **options)
    assert state.step == 32
    if keyword == "profile_dir":
        assert streams == []
        assert len(list((tmp_path / value).glob("*.pt.trace.json"))) == 1
    elif keyword in ("chunk_layout", "stratified_widths"):
        cuts = (16, 32) if keyword == "stratified_widths" else (32,)
        assert [kwargs["cuts"] for kwargs in streams] == [cuts]
    elif keyword == "prefetch_depth":
        assert depths == [1]
    elif keyword == "k":
        import random
        assert moves == [(2, random.Random(42).random())]
    else:
        for name in ("training_input_vocab.txt",
                     "training_target_vocab.txt"):
            assert os.path.isfile(os.path.join(data_directory, name))


# ---------------------------------------------------------------------------
# The encoder kernel: only on the card, only without autograd
# ---------------------------------------------------------------------------

def calls_of(monkeypatch, module, name):
    """The list that every later call of ``module.name`` appends to."""
    calls, inner = [], getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return inner(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("layers", [1, 2])
def test_encoder_kernel_not_taken_on_the_cpu_or_under_autograd(
        monkeypatch, layers, bidirectional):
    from torch.profiler import ProfilerActivity, profile
    from multimodal_seq2seq_gscan_tpu_torch.models import model
    from multimodal_seq2seq_gscan_tpu_torch.ops import encoder_lstm
    from multimodal_seq2seq_gscan_tpu_torch.utils import profiling
    config = ModelConfig(**tiny_kwargs(num_encoder_layers=layers,
                                       encoder_bidirectional=bidirectional))
    params = create_train_state(3, config, Adam(), device="cpu").params
    _, batch = random_batch(5)
    args = (params, config, batch.input_ids, batch.input_lengths,
            batch.situations)
    scans = calls_of(monkeypatch, model, "masked_lstm_scan")
    wrapper = calls_of(monkeypatch, encoder_lstm, "encoder_layer")
    launches = encoder_lstm.launches
    with profile(activities=[ProfilerActivity.CPU]), \
            profiling.span("test") as record:
        with torch.no_grad():
            plain = model.encode_input(*args)
        model.encode_input(*args)
        for leaf in leaves(params):
            leaf.requires_grad_(True)
        with torch.enable_grad():
            graded = model.encode_input(*args)
    directions = 2 if bidirectional else 1
    assert len(scans) == 3 * layers * directions
    assert wrapper == [] and encoder_lstm.launches == launches
    assert record.counts.get("encoder_kernel_layers", 0) == 0
    assert graded.encoded_commands.requires_grad
    assert torch.equal(graded.encoded_commands.detach(),
                       plain.encoded_commands)
    assert torch.equal(graded.hidden.detach(), plain.hidden)
    with pytest.raises(RuntimeError, match="no backward"):
        encoder_lstm.encoder_layer(
            torch.zeros(2, 3, 8), torch.tensor([3, 1]),
            params.encoder.fwd_layers[0], None, sum_directions=True)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("layers", [1, 2])
def test_encoder_kernel_branch_calls_the_wrapper_a_layer_at_a_time(
        monkeypatch, layers, bidirectional):
    from multimodal_seq2seq_gscan_tpu_torch.models import model
    from multimodal_seq2seq_gscan_tpu_torch.models.nn import sequence_mask
    from multimodal_seq2seq_gscan_tpu_torch.ops import encoder_lstm
    config = ModelConfig(**tiny_kwargs(
        num_encoder_layers=layers, encoder_bidirectional=bidirectional,
        encoder_dropout_p=0.3))
    params = create_train_state(4, config, Adam(), device="cpu").params
    encoder = params.encoder
    _, batch = random_batch(6)
    args = (params, config, batch.input_ids, batch.input_lengths,
            batch.situations)
    calls = []

    def stand_in(x, lengths, forward, backward, *, sum_directions,
                 with_hidden=True):
        calls.append((forward, backward, sum_directions, with_hidden))
        out, hidden = model._scan_layer(
            forward, backward, x, sequence_mask(lengths, x.shape[1]),
            lengths, sum_directions=sum_directions)
        return out, hidden if with_hidden else None

    for deterministic in (True, False):
        want = model.encode_input(
            *args, generator=torch.Generator().manual_seed(1),
            deterministic=deterministic)
        with monkeypatch.context() as patch:
            patch.setattr(model, "_encoder_kernel_applies",
                          lambda *_: True)
            patch.setattr(encoder_lstm, "encoder_layer", stand_in)
            got = model.encode_input(
                *args, generator=torch.Generator().manual_seed(1),
                deterministic=deterministic)
        for field in ("encoded_commands", "hidden"):
            torch.testing.assert_close(getattr(got, field),
                                       getattr(want, field), rtol=0, atol=0)
    assert len(calls) == 2 * layers
    for i, (forward, backward, summed, hidden) in enumerate(
            calls[:layers]):
        assert forward is encoder.fwd_layers[i]
        assert backward is (None if encoder.bwd_layers is None
                            else encoder.bwd_layers[i])
        assert summed == hidden == (i == layers - 1)
