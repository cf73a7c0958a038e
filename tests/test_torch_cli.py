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
- ``--data_parallel`` above 1 (ROADMAP A11) is refused by name, with or
  without ``--seeds`` (a campaign runs since A10: test_torch_multiseed.py).
"""

import json
import os

import flax.serialization
import jax
import numpy as np
import pytest

from multimodal_seq2seq_gscan_tpu.cli.seq2seq import (
    build_parser as jax_build_parser)
from multimodal_seq2seq_gscan_tpu.data.dataset import (
    GroundedScanDataset as JaxDataset)
from multimodal_seq2seq_gscan_tpu.decode.predict import (
    predict_and_save as jax_predict_and_save)
from multimodal_seq2seq_gscan_tpu.models import ModelConfig as JaxConfig
from multimodal_seq2seq_gscan_tpu.models import init_model_params
from multimodal_seq2seq_gscan_tpu_torch.cli import seq2seq
from multimodal_seq2seq_gscan_tpu_torch.train.checkpoint import (
    read_checkpoint)
from tests.test_torch_predict import CLOSE_KEYS, EXACT_KEYS
from tests.test_torch_decode_dtype import one_torch_thread  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "data",
                       "bench_fixture")
CHECKPOINT = os.path.join(FIXTURE, "model_best.msgpack")
N_EXAMPLES = 64


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


def test_test_mode_writes_jax_predictions(tmp_path, jax_records):
    got = run_test(tmp_path)
    assert len(got) == len(jax_records) == N_EXAMPLES
    for record, ref in zip(got, jax_records):
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


@pytest.mark.parametrize("flags,item", [
    (("--seeds=1,2", "--data_parallel=2"), "A11"),
    (("--data_parallel=2",), "A11")])
def test_seeds_and_data_parallel_are_refused_by_name(tmp_path, flags, item):
    with pytest.raises(NotImplementedError, match=item):
        seq2seq.main(parse("--mode=train", "--data_directory=" + FIXTURE,
                           "--output_directory=" + str(tmp_path), *flags),
                     device="cpu")
