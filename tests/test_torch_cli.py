"""The port's command line against the JAX package's, on the CPU.

- ``build_parser`` has JAX's flags, defaults and choices; only
  ``--teacher_forced_impl`` differs: it also takes the port's names, and its
  default is the port's ``"fused"`` (``"pallas"`` is taken as ``"fused"``,
  ``"xla"`` as ``"step"``).
- ``main(..., device="cpu")`` with ``--mode=train`` resumes from the
  fixture's ``model_best.msgpack`` (step 200000) and trains in resident
  chunks to iteration 200020, evaluating and checkpointing there.
- ``--mode=test`` writes a ``dev_predict.json`` over 64 fixture dev
  examples equal to JAX's ``predict_and_save`` on the same checkpoint, at
  the bars of tests/test_torch_predict.py (words, derivations, situations,
  accuracies equal; attention stacks rtol 1e-5 / atol 1e-6), and
  ``--decode_dtype=bfloat16_keys`` predicts the same sequences.
- ``--data_parallel``'s help says what ``main`` does with it (C.13).
- ``--data_parallel=2 --mode=test`` on two gloo ranks writes the single
  run's ``dev_predict.json`` byte for byte; ``--seeds`` with
  ``--data_parallel`` is refused, as JAX refuses it, and on the card more
  ranks than GPUs are refused.
"""

import json
import os

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from chip_smoke import chunk_losses
from multimodal_seq2seq_gscan_tpu.cli.seq2seq import (
    build_parser as jax_build_parser)
from multimodal_seq2seq_gscan_tpu.cli.seq2seq import main as jax_main
from multimodal_seq2seq_gscan_tpu.data.dataset import (
    GroundedScanDataset as JaxDataset)
from multimodal_seq2seq_gscan_tpu.decode.predict import (
    predict_and_save as jax_predict_and_save)
from multimodal_seq2seq_gscan_tpu.models import ModelConfig as JaxConfig
from multimodal_seq2seq_gscan_tpu.models import init_model_params
from multimodal_seq2seq_gscan_tpu.train import resident as jax_resident
from multimodal_seq2seq_gscan_tpu_torch.cli import seq2seq
from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
    GroundedScanDataset)
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.params import tree_map
from multimodal_seq2seq_gscan_tpu_torch.train import loop as port_loop
from multimodal_seq2seq_gscan_tpu_torch.train.checkpoint import (
    read_checkpoint, save_checkpoint)
from multimodal_seq2seq_gscan_tpu_torch.train.state import (
    Adam, create_train_state)
from tests.test_torch_predict import CLOSE_KEYS, EXACT_KEYS
from tests.test_torch_decode_dtype import one_torch_thread  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "data",
                       "bench_fixture")
CHECKPOINT = os.path.join(FIXTURE, "model_best.msgpack")
N_EXAMPLES = 64
# Decoded at H = 512 (a model of a few steps stops early in few rows):
# examples and the steps' cap.
WIDE_EXAMPLES = 16
WIDE_DECODING_STEPS = 30


def parse(*args):
    return vars(seq2seq.build_parser().parse_args(list(args)))


def test_parser_has_the_jax_flags():
    def actions(parser):
        return {(tuple(a.option_strings), a.dest): (a.default, a.choices,
                                                     a.nargs, a.const)
                for a in parser._actions}

    port, ref = actions(seq2seq.build_parser()), actions(jax_build_parser())
    assert port.keys() == ref.keys()
    different = {key for key in port if port[key] != ref[key]}
    assert different == {(("--teacher_forced_impl",), "teacher_forced_impl")}
    flags = parse("--mode=train", "--teacher_forced_impl=pallas")
    assert flags["teacher_forced_impl"] == "pallas"
    assert parse("--mode=train")["teacher_forced_impl"] == "fused"


def test_data_parallel_help_says_what_main_does():
    """C.13: ``--data_parallel``'s help describes the flag as ``main``
    runs it (both modes on n ranks), not as refused."""
    text = seq2seq.build_parser().format_help()
    action, = [a for a in seq2seq.build_parser()._actions
               if a.dest == "data_parallel"]
    assert "refused" not in action.help and "not ported" not in action.help
    for words in ("--mode=train", "--mode=test", "NCCL", "gloo"):
        assert words in action.help, words
    assert "--data_parallel" in text


def test_train_resumes_for_20_resident_steps(tmp_path, monkeypatch):
    from multimodal_seq2seq_gscan_tpu_torch.train import loop
    taken = {}
    train = loop.train

    def spy(**kwargs):
        taken.update(kwargs)
        return train(**kwargs)

    monkeypatch.setattr(loop, "train", spy)
    out = tmp_path / "out"
    seq2seq.main(parse(
        "--mode=train", "--data_directory=" + FIXTURE,
        "--output_directory=" + str(out),
        "--resume_from_file=" + CHECKPOINT, "--training_batch_size=8",
        "--max_training_examples=16", "--max_testing_examples=8",
        "--test_batch_size=8", "--max_training_iterations=200020",
        "--print_every=10", "--evaluate_every=20",
        "--steps_per_execution=10", "--max_decoding_steps=120",
        "--teacher_forced_impl=pallas"), device="cpu")
    assert taken["teacher_forced_impl"] == "fused"
    assert taken["evaluation_batch_size"] == 8 and taken["device"] == "cpu"
    with open(out / "checkpoint.msgpack.json") as f:
        assert json.load(f)["iteration"] == 200021
    assert read_checkpoint(str(out / "checkpoint.msgpack"))["step"] == 200021


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    """JAX's predict.json records of the first 64 fixture dev examples."""
    data = JaxDataset(os.path.join(FIXTURE, "dataset.txt"), FIXTURE, k=0,
                      split="dev",
                      input_vocabulary_file="training_input_vocab.txt",
                      target_vocabulary_file="training_target_vocab.txt",
                      generate_vocabulary=False)
    data.read_dataset(max_examples=N_EXAMPLES)
    config = JaxConfig(input_vocabulary_size=data.input_vocabulary_size,
                       target_vocabulary_size=data.target_vocabulary_size,
                       num_cnn_channels=data.image_channels)
    template = jax.eval_shape(lambda key: init_model_params(key, config),
                              jax.random.PRNGKey(0))
    params = flax.serialization.from_state_dict(
        template, read_checkpoint(CHECKPOINT)["params"])
    path = jax_predict_and_save(
        data, params, config,
        str(tmp_path_factory.mktemp("jax") / "predict.json"),
        max_decoding_steps=120, batch_size=N_EXAMPLES,
        max_testing_examples=N_EXAMPLES)
    with open(path) as f:
        return json.load(f)


def run_test(tmp_path, *extra):
    seq2seq.main(parse(
        "--mode=test", "--data_directory=" + FIXTURE,
        "--output_directory=" + str(tmp_path),
        "--resume_from_file=" + CHECKPOINT, "--splits=dev",
        "--max_testing_examples={}".format(N_EXAMPLES),
        "--test_batch_size={}".format(N_EXAMPLES),
        "--max_decoding_steps=120", *extra), device="cpu")
    with open(tmp_path / "dev_predict.json") as f:
        return json.load(f)


def flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    return {k: v for name, sub in tree.items()
            for k, v in flat(sub, prefix + "/" + name).items()}


def train_both(tmp_path, monkeypatch, hidden):
    """Both packages' ``--mode=train`` at encoder and decoder width
    ``hidden`` for one resident chunk of 4 steps (iterations 9-12, batch 8,
    dropout 0, a dev evaluation of 8 at 12), from one checkpoint at step 9:
    the port's init from seed 42 with a random non-zero Adam state (as
    tests/test_torch_train.py starts): per-step losses rtol 1e-5, the
    checkpoints' params atol 1e-6. Returns the flags that set the width and
    the port's checkpoint."""
    train_set = GroundedScanDataset(os.path.join(FIXTURE, "dataset.txt"),
                                    FIXTURE, split="train")
    train_set.read_dataset(max_examples=1)
    config = ModelConfig(
        input_vocabulary_size=train_set.input_vocabulary_size,
        target_vocabulary_size=train_set.target_vocabulary_size,
        num_cnn_channels=train_set.image_channels,
        encoder_hidden_size=hidden, decoder_hidden_size=hidden)
    state = create_train_state(42, config, Adam(), device="cpu")
    rng = np.random.RandomState(3)
    mu = tree_map(lambda p: torch.from_numpy(
        rng.randn(*p.shape).astype(np.float32) * 1e-3), state.params)
    nu = tree_map(lambda p: torch.from_numpy(
        rng.uniform(1e-6, 1e-5, p.shape).astype(np.float32)), state.params)
    start = save_checkpoint(str(tmp_path / "start"), state._replace(
        step=9, opt_state=state.opt_state._replace(
            count=9, mu=mu, nu=nu, schedule_count=9)))
    width = ("--encoder_hidden_size={}".format(hidden),
             "--decoder_hidden_size={}".format(hidden))
    flags = ["--mode=train", "--data_directory=" + FIXTURE,
             "--resume_from_file=" + start, "--encoder_dropout_p=0",
             "--decoder_dropout_p=0", "--cnn_dropout_p=0",
             "--training_batch_size=8", "--max_training_examples=16",
             "--max_testing_examples=8", "--test_batch_size=8",
             "--max_training_iterations=12", "--print_every=4",
             "--evaluate_every=4", "--steps_per_execution=4",
             "--max_decoding_steps={}".format(WIDE_DECODING_STEPS),
             "--compilation_cache_dir=", *width]
    losses = {"jax": [], "port": []}
    monkeypatch.setattr(jax_resident, "make_train_chunk", chunk_losses(
        jax_resident.make_train_chunk, losses["jax"]))
    monkeypatch.setattr(port_loop, "make_train_chunk", chunk_losses(
        port_loop.make_train_chunk, losses["port"]))
    jax_main(vars(jax_build_parser().parse_args(
        flags + ["--output_directory=" + str(tmp_path / "jax")])))
    seq2seq.main(parse(*flags, "--output_directory=" + str(tmp_path /
                                                          "port")),
                 device="cpu")
    assert len(losses["port"]) == len(losses["jax"]) == 4
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    port = tmp_path / "port" / "checkpoint.msgpack"
    got, want = (read_checkpoint(str(path)) for path in (
        port, tmp_path / "jax" / "checkpoint.msgpack"))
    assert got["step"] == want["step"] == 13
    got, want = flat(got["params"]), flat(want["params"])
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-6,
                                   err_msg=name)
    return width, str(port)


@pytest.mark.parametrize("hidden", [100, 512])
def test_test_mode_writes_jax_predictions(tmp_path, jax_records, hidden,
                                          monkeypatch):
    """``--mode=test``'s ``dev_predict.json`` against JAX's records: at the
    fixture's width on its checkpoint (JAX's ``predict_and_save``, 64
    examples); at encoder and decoder H = 512 on the checkpoint of one
    resident chunk that both packages' ``--mode=train`` trained alike
    (``train_both``), JAX's records from its own ``--mode=test`` of that
    checkpoint (16 examples, 31 steps at most)."""
    if hidden == 100:
        got, want = run_test(tmp_path), jax_records
    else:
        width, checkpoint = train_both(tmp_path, monkeypatch, hidden)
        examples = ("--max_testing_examples={}".format(WIDE_EXAMPLES),
                    "--test_batch_size={}".format(WIDE_EXAMPLES),
                    "--max_decoding_steps={}".format(WIDE_DECODING_STEPS))
        got = run_test(tmp_path / "port",
                       "--resume_from_file=" + checkpoint, *width,
                       *examples)
        jax_main(vars(jax_build_parser().parse_args([
            "--mode=test", "--data_directory=" + FIXTURE,
            "--output_directory=" + str(tmp_path / "jax"),
            "--resume_from_file=" + checkpoint, "--splits=dev",
            "--compilation_cache_dir=", *width, *examples])))
        with open(tmp_path / "jax" / "dev_predict.json") as f:
            want = json.load(f)
    assert len(got) == len(want) == (N_EXAMPLES if hidden == 100
                                     else WIDE_EXAMPLES)
    for record, ref in zip(got, want):
        assert list(record) == list(ref)
        for key in EXACT_KEYS:
            assert record[key] == ref[key], key
        for key in CLOSE_KEYS:
            np.testing.assert_allclose(
                np.asarray(record[key], np.float64),
                np.asarray(ref[key], np.float64), rtol=1e-5, atol=1e-6,
                err_msg=key)


def test_test_mode_bfloat16_keys(tmp_path, jax_records):
    got = run_test(tmp_path, "--decode_dtype=bfloat16_keys")
    assert [r["prediction"] for r in got] == \
        [r["prediction"] for r in jax_records]


@pytest.mark.parametrize("flags,device,error,match", [
    (("--seeds=1,2", "--data_parallel=2"), "cpu", NotImplementedError,
     "single-chip"),
    (("--data_parallel=2",), "cuda", ValueError,
     "2 ranks need 2 GPUs but only")])
def test_seeds_and_data_parallel_are_refused_by_name(tmp_path, flags, device,
                                                     error, match):
    """A campaign with ``--data_parallel`` stays refused, as JAX refuses
    it; on the card, more ranks than GPUs are refused (never run on fewer
    ranks or on the CPU). This machine has no GPU."""
    if device == "cuda" and torch.cuda.device_count() >= 2:
        pytest.skip("this machine has two GPUs")
    with pytest.raises(error, match=match):
        seq2seq.main(parse("--mode=train", "--data_directory=" + FIXTURE,
                           "--output_directory=" + str(tmp_path), *flags),
                     device=device)


def test_data_parallel_test_mode_equals_single_run(tmp_path):
    """``--data_parallel=2 --mode=test`` on two gloo ranks writes the
    single run's ``dev_predict.json`` byte for byte."""
    (tmp_path / "single").mkdir()
    (tmp_path / "ranks").mkdir()
    run_test(tmp_path / "single")
    run_test(tmp_path / "ranks", "--data_parallel=2")
    single = (tmp_path / "single" / "dev_predict.json").read_bytes()
    ranks = (tmp_path / "ranks" / "dev_predict.json").read_bytes()
    assert ranks == single and b'"prediction"' in ranks
