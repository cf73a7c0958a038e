"""The port's multi-seed campaign trainer (``train/multiseed.py``) against
its single-seed runs and the JAX package's, on the CPU.

- The multi-seed chunk equals each seed's own chunk bit for bit, dropout
  on, and its ``slice_train_state`` gives views of the stacked buffer.
- It equals JAX's ``make_multiseed_train_chunk`` from the same params,
  carried across, dropout 0, with and without segments, at the bars of
  JAX's resident chunk tests (losses rtol 2e-5, params and moments rtol
  2e-5 / atol 1e-6).
- ``train(seeds="7,8")`` on a small dataset generated by the JAX package's
  engine writes ``seed_7/`` and ``seed_8/``, whose checkpoints (the running
  one and ``model_best``, with their sidecars) and logged metrics equal
  single-seed ``train(seed=7)`` and ``train(seed=8)`` byte for byte, and
  logs JAX's ``[seed N]`` lines; ``--seeds`` through the command line
  writes the same files.
- A campaign stopped at an evaluation and resumed equals the uninterrupted
  one byte for byte.
- The training step takes cuDNN's deterministic algorithms.
- The guards: a resume path that is not the campaign's directory, a
  changed batch size, chunk size or layout, and seeds at different
  iterations are refused; an evaluation's renames that a kill interrupted
  are completed on resume.
"""

import filecmp
import json
import logging
import math
import os
import random
import shutil
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_seq2seq_gscan_tpu.models import ModelConfig as JaxConfig
from multimodal_seq2seq_gscan_tpu.models import init_model_params
from multimodal_seq2seq_gscan_tpu.train import multiseed as jax_multiseed
from multimodal_seq2seq_gscan_tpu.train import resident as jax_resident
from multimodal_seq2seq_gscan_tpu.train.state import (
    TrainState as JaxState)
from multimodal_seq2seq_gscan_tpu.train.state import make_optimizer
from multimodal_seq2seq_gscan_tpu_torch.cli import seq2seq
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.params import leaves
from multimodal_seq2seq_gscan_tpu_torch.train import (
    loop, multiseed, resident)
from multimodal_seq2seq_gscan_tpu_torch.train.loop import train
from multimodal_seq2seq_gscan_tpu_torch.train.state import (
    Adam, AdamState, TrainState, create_train_state)
from tests.test_torch_decode_dtype import one_torch_thread  # noqa: F401
from tests.test_torch_resident import (
    assert_trees_close, toy_kwargs, toy_problem)
from tests.test_torch_train import random_opt_state, to_torch

SEEDS = (7, 8)
FILES = ("checkpoint.msgpack", "checkpoint.msgpack.json",
         "model_best.msgpack", "model_best.msgpack.json")


def test_chunk_equals_each_seeds_chunk_with_dropout():
    _, data = toy_problem()
    config = ModelConfig(**toy_kwargs())
    states = [create_train_state(s, config, Adam(), "cpu") for s in SEEDS]
    blocks = np.stack([next(resident.index_block_stream(
        24, 8, 3, np.random.default_rng(s))) for s in SEEDS])
    stacked = multiseed.stack_train_states(states)
    seed_1 = multiseed.slice_train_state(stacked, 1)
    assert leaves(seed_1.params)[0].data_ptr() == \
        stacked.flat[1].data_ptr()  # the first leaf of row 1: a view
    new, metrics = multiseed.make_multiseed_train_chunk(config, Adam())(
        stacked, data, blocks)
    assert all(v.shape == (2, 3) for v in metrics.values())
    assert new.step == new.count == new.schedule_count == (3, 3)
    single = resident.make_train_chunk(config, Adam())
    for i, (state, block) in enumerate(zip(states, blocks)):
        want, want_metrics = single(state, data, block)
        got = multiseed.slice_train_state(new, i)
        for name in resident.METRIC_NAMES:
            assert torch.equal(metrics[name][i], want_metrics[name]), name
        for a, b in zip(leaves(got.params) + leaves(got.opt_state.mu)
                        + leaves(got.opt_state.nu),
                        leaves(want.params) + leaves(want.opt_state.mu)
                        + leaves(want.opt_state.nu)):
            assert torch.equal(a, b)
        assert got.step == want.step == 3
        np.testing.assert_array_equal(got.rng, want.rng)


def seed_states(kwargs):
    """Each seed's state for both packages: JAX-initialised params, a
    random non-zero Adam state of 7 steps, step 7."""
    jax_states, port_states = [], []
    for s in SEEDS:
        params = init_model_params(jax.random.PRNGKey(s), JaxConfig(**kwargs))
        opt_state = random_opt_state(params, 7, seed=s)
        jax_states.append(JaxState(step=jnp.int32(7), params=params,
                                   opt_state=opt_state,
                                   rng=jax.random.PRNGKey(s)))
        port_states.append(TrainState(
            step=7, params=to_torch(params),
            opt_state=AdamState(7, to_torch(opt_state[0].mu),
                                to_torch(opt_state[0].nu), 7),
            rng=np.asarray(jax_states[-1].rng)))
    return jax_states, port_states


@pytest.mark.parametrize("segmented", [False, True])
def test_chunk_equals_jax_multiseed_chunk(segmented):
    host, data = toy_problem()
    kwargs = toy_kwargs(encoder_dropout_p=0.0, decoder_dropout_p=0.0,
                        cnn_dropout_p=0.0)
    jax_states, port_states = seed_states(kwargs)
    k, batch = 4, 8
    segments = None
    if segmented:
        cut = int(np.median(host.target_lengths))
        pairs = [next(resident.stratified_index_block_stream(
            host.target_lengths, batch, k, np.random.default_rng(s),
            cuts=(cut,))) for s in SEEDS]
        segments = pairs[0][1]
        assert all(spec == segments for _, spec in pairs)
        assert len(segments) == 2
        blocks = np.stack([block for block, _ in pairs])
    else:
        blocks = np.stack([next(resident.index_block_stream(
            24, batch, k, np.random.default_rng(s))) for s in SEEDS])
    ref_chunk = jax_multiseed.make_multiseed_train_chunk(
        JaxConfig(**kwargs), make_optimizer(), donate=False)
    ref_stacked, ref_metrics = ref_chunk(
        jax_multiseed.stack_train_states(jax_states),
        jax_resident.ResidentData(*(jax.device_put(a) for a in host)),
        blocks, segments)
    chunk = multiseed.make_multiseed_train_chunk(ModelConfig(**kwargs),
                                                 Adam())
    stacked, metrics = chunk(multiseed.stack_train_states(port_states),
                             data, blocks, segments)
    for name in resident.METRIC_NAMES:
        np.testing.assert_allclose(metrics[name].numpy(),
                                   np.asarray(ref_metrics[name]),
                                   rtol=2e-5, atol=1e-4 if name != "loss"
                                   else 0, err_msg=name)
    for i in range(len(SEEDS)):
        state = multiseed.slice_train_state(stacked, i)
        ref = jax_multiseed.slice_train_state(ref_stacked, i)
        assert_trees_close(state.params, ref.params, 2e-5, 1e-6)
        assert_trees_close(state.opt_state.mu, ref.opt_state[0].mu, 2e-5,
                           1e-6)
        assert_trees_close(state.opt_state.nu, ref.opt_state[0].nu, 2e-5,
                           1e-6)
        assert state.step == int(ref.step) == 11


@pytest.fixture(scope="module")
def tiny_dataset_dir(tmp_path_factory):
    """A small uniform dataset made by the JAX package's engine (the one of
    tests/test_multiseed.py), with vocabularies generated from its train
    split."""
    from multimodal_seq2seq_gscan_tpu.gscan import GroundedScan
    from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
        GroundedScanDataset)

    directory = str(tmp_path_factory.mktemp("tiny_gscan_ms"))
    random.seed(11)
    np.random.seed(11)
    dataset = GroundedScan(
        intransitive_verbs=["walk"], transitive_verbs=["push"],
        adverbs=[], nouns=["circle", "square"],
        color_adjectives=["red", "green"], size_adjectives=["big", "small"],
        percentage_train=0.8, min_object_size=1, max_object_size=4,
        sample_vocabulary="default", save_directory=directory, grid_size=6,
        type_grammar="normal")
    dataset.get_data_pairs(max_examples=300, num_resampling=1,
                           split_type="uniform", make_dev_set=True)
    dataset.save_dataset("dataset.txt")
    GroundedScanDataset(os.path.join(directory, "dataset.txt"), directory,
                        generate_vocabulary=True).save_vocabularies(
        "training_input_vocab.txt", "training_target_vocab.txt")
    return directory


TRAIN = dict(
    training_batch_size=8, max_decoding_steps=20, embedding_dimension=8,
    encoder_hidden_size=12, decoder_hidden_size=12, cnn_kernel_size=3,
    cnn_hidden_num_channels=6, print_every=4, evaluate_every=4,
    steps_per_execution=4, max_testing_examples=16,
    evaluation_batch_size=16, device="cpu")


def run(directory, out, caplog=None, **overrides):
    events = []
    kwargs = dict(TRAIN, max_training_iterations=8)
    kwargs.update(overrides)
    train(os.path.join(directory, "dataset.txt"), directory,
          output_directory=str(out),
          callback=lambda *event: events.append(event), **kwargs)
    return events


def scored(evaluate):
    """``evaluate`` whose exact match is a function of the params, so that
    the few steps here move it up and down and ``model_best`` is written
    and kept as on a run that learns."""
    def wrapper(dataset, params, *args, **kwargs):
        accuracy, _, target_accuracy = evaluate(dataset, params, *args,
                                                **kwargs)
        return accuracy, 50.0 + 50.0 * math.sin(
            1e3 * float(params.enc_to_dec_w.double().sum())), target_accuracy
    return wrapper


@pytest.fixture(scope="module", autouse=True)
def scored_evaluations():
    with mock.patch.object(loop, "evaluate", scored(loop.evaluate)), \
            mock.patch.object(multiseed, "evaluate",
                              scored(multiseed.evaluate)):
        yield


@pytest.fixture(scope="module")
def runs(tiny_dataset_dir, tmp_path_factory):
    """A campaign of seeds 7 and 8 to iteration 10 (two chunks, an
    evaluation after each, a tail of two single steps), its log, and
    single-seed runs of each seed."""
    root = tmp_path_factory.mktemp("multiseed_runs")
    handler, logger = _Capture(), logging.getLogger(multiseed.__name__)
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        campaign = run(tiny_dataset_dir, root / "campaign",
                       seeds="7,8", max_training_iterations=10)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    singles = {s: run(tiny_dataset_dir, root / "single_{}".format(s),
                      seed=s, max_training_iterations=10) for s in SEEDS}
    return root, campaign, handler.lines, singles


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def same_files(left, right):
    assert sorted(os.listdir(left)) == sorted(os.listdir(right))
    for name in FILES:
        assert filecmp.cmp(left / name, right / name, shallow=False), name


def test_campaign_equals_single_seed_runs(runs):
    root, campaign, lines, singles = runs
    for s in SEEDS:
        same_files(root / "campaign" / "seed_{}".format(s),
                   root / "single_{}".format(s))
        mine = [(kind, it, {k: v for k, v in values.items()
                            if k not in ("seed", "steps_per_s")})
                for kind, it, values in campaign if values["seed"] == s]
        want = [(kind, it, {k: v for k, v in values.items()
                            if k != "steps_per_s"})
                for kind, it, values in singles[s]]
        assert mine == want and [e[:2] for e in want] == [
            ("train", 4), ("eval", 4), ("train", 8), ("eval", 8)]
        with open(root / "single_{}".format(s) / FILES[1]) as f:
            assert json.load(f)["best_exact_match"] > 0
        assert sum("Iteration 00000008 [seed {}], loss".format(s) in line
                   for line in lines) == 1
        assert sum("  Evaluation [seed {}] Accuracy:".format(s) in line
                   for line in lines) == 2
    with open(root / "campaign" / multiseed.CAMPAIGN_FILE) as f:
        assert json.load(f) == {
            "seeds": [7, 8], "training_batch_size": 8, "steps_per_chunk": 4,
            "chunk_layout": "full", "stratified_options": None}
    assert not list((root / "campaign").glob("seed_*/*" + multiseed.PENDING
                                             + "*"))


def test_command_line_seeds_writes_the_same_campaign(runs, tiny_dataset_dir):
    root = runs[0]
    out = root / "cli"
    flags = vars(seq2seq.build_parser().parse_args([
        "--mode=train", "--data_directory=" + tiny_dataset_dir,
        "--output_directory=" + str(out), "--seeds=7,8",
        "--training_batch_size=8", "--max_decoding_steps=20",
        "--embedding_dimension=8", "--encoder_hidden_size=12",
        "--decoder_hidden_size=12", "--cnn_kernel_size=3",
        "--cnn_hidden_num_channels=6", "--print_every=4",
        "--evaluate_every=4", "--steps_per_execution=4",
        "--max_testing_examples=16", "--test_batch_size=16",
        "--max_training_iterations=10"]))
    seq2seq.main(flags, device="cpu")
    for s in SEEDS:
        same_files(out / "seed_{}".format(s),
                   root / "campaign" / "seed_{}".format(s))


def test_resumed_campaign_equals_uninterrupted(runs, tiny_dataset_dir):
    root = runs[0]
    out = root / "resumed"
    run(tiny_dataset_dir, out, seeds="7,8", max_training_iterations=4)
    events = run(tiny_dataset_dir, out, seeds="7,8",
                 max_training_iterations=10, resume_from_file=str(out))
    assert [e[:2] for e in events if e[2]["seed"] == 7] == [
        ("train", 8), ("eval", 8)]
    for s in SEEDS:
        same_files(out / "seed_{}".format(s),
                   root / "campaign" / "seed_{}".format(s))


@pytest.fixture()
def stopped(runs, tiny_dataset_dir, tmp_path):
    """A copy of a campaign stopped at its evaluation of iteration 4."""
    out = tmp_path / "stopped"
    source = runs[0] / "stopped"
    if not source.exists():
        run(tiny_dataset_dir, source, seeds="7,8", max_training_iterations=4)
    shutil.copytree(source, out)
    return out


@pytest.mark.parametrize("change,match", [
    (dict(resume_from_file="OTHER"), "resumes from its own output"),
    (dict(training_batch_size=4), "training_batch_size"),
    (dict(steps_per_execution=2), "steps_per_chunk"),
    (dict(chunk_layout="stratified"), "chunk_layout"),
    (dict(seeds="7,9"), "seeds")])
def test_resume_guards_refuse(stopped, tiny_dataset_dir, change, match):
    options = dict(seeds="7,8", max_training_iterations=8,
                   resume_from_file=str(stopped))
    options.update(change)
    if options["resume_from_file"] == "OTHER":
        options["resume_from_file"] = str(stopped / "seed_7")
    with pytest.raises(ValueError, match=match):
        run(tiny_dataset_dir, stopped, **options)


def test_seeds_at_different_iterations_are_refused(runs, stopped,
                                                   tiny_dataset_dir):
    later = runs[0] / "campaign" / "seed_8"
    for name in FILES[:2]:
        shutil.copyfile(later / name, stopped / "seed_8" / name)
    with pytest.raises(ValueError, match="different iterations"):
        run(tiny_dataset_dir, stopped, seeds="7,8",
            max_training_iterations=10, resume_from_file=str(stopped))


def test_interrupted_renames_are_completed(runs, stopped, tiny_dataset_dir):
    """Seed 7 renamed its checkpoint of iteration 8, seed 8 was killed
    before: its pending files complete the evaluation on resume."""
    later = runs[0] / "campaign"
    for name in FILES[:2]:
        shutil.copyfile(later / "seed_7" / name, stopped / "seed_7" / name)
        pending = name.replace(".msgpack", ".msgpack" + multiseed.PENDING)
        shutil.copyfile(later / "seed_8" / name, stopped / "seed_8" / pending)
    run(tiny_dataset_dir, stopped, seeds="7,8", max_training_iterations=10,
        resume_from_file=str(stopped))
    for s in SEEDS:
        for name in FILES[:2]:
            assert filecmp.cmp(stopped / "seed_{}".format(s) / name,
                               later / "seed_{}".format(s) / name,
                               shallow=False), (s, name)


def test_training_step_takes_deterministic_convolutions(monkeypatch):
    """The step runs cuDNN's deterministic algorithms (its default weight
    gradient for the CNN adds with atomics, which parted a campaign from
    its single-seed runs on the card) and gives the caller's flag back."""
    from multimodal_seq2seq_gscan_tpu_torch.models import model
    from multimodal_seq2seq_gscan_tpu_torch.train.step import train_step
    _, data = toy_problem()
    config = ModelConfig(**toy_kwargs())
    seen, encode = [], model.encode_input

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.deterministic)
        return encode(*args, **kwargs)

    monkeypatch.setattr(model, "encode_input", spy)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    train_step(create_train_state(7, config, Adam(), "cpu"),
               resident.gather_batch(data, np.arange(8)), config, Adam())
    assert seen == [True] and torch.backends.cudnn.deterministic is False
