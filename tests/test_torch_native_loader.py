"""The port's native loader (``data/native_loader.py`` over its own copy of
the C++ scanner) against its json engine and the JAX package's native
backend, on the CPU (the host's g++ builds the library at first use).

- On a small dataset made by the JAX package's engine, the port's
  ``"native"`` and ``"engine"`` backends give equal arrays, lazy strings
  (situations, derivations) and vocabularies, and both equal JAX's native
  backend; the k-shot move takes the same examples in both backends and
  in JAX's native one; splits that share a parse take its backend.
- ``"auto"`` takes native; with no compiler (monkeypatched) ``"auto"``
  falls back to engine with a warning and ``"native"`` raises.
- ``predict_and_save`` writes the same bytes from either backend.
- A truncated or out-of-grid dataset.txt raises ``ValueError``, as JAX's
  scanner does (tests/test_native_loader.py's payloads).
"""

import logging
import os
import random
import subprocess

import numpy as np
import pytest

from multimodal_seq2seq_gscan_tpu.data import native_loader as jax_native
from multimodal_seq2seq_gscan_tpu.data.dataset import (
    GroundedScanDataset as JaxDataset)
from multimodal_seq2seq_gscan_tpu_torch.data import dataset as data_mod
from multimodal_seq2seq_gscan_tpu_torch.data import native_loader
from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
    GroundedScanDataset)
from multimodal_seq2seq_gscan_tpu_torch.decode.predict import (
    predict_and_save)
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.train.state import (
    Adam, create_train_state)
from tests.test_native_loader import test_native_loader_rejects_corrupt_files
from tests.test_torch_decode_dtype import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
VOCABS = ("iv.txt", "tv.txt")
PAYLOADS = test_native_loader_rejects_corrupt_files.pytestmark[0].args[1]


@pytest.fixture(scope="module")
def dataset_path(tmp_path_factory):
    """tests/test_native_loader.py's dataset: 300 uniform examples of a
    6x6 grid from the JAX package's engine, with an ``adverb_1`` split
    (test examples) for the k-shot move."""
    import json

    from multimodal_seq2seq_gscan_tpu.gscan import GroundedScan
    directory = str(tmp_path_factory.mktemp("torch_native_ds"))
    random.seed(9)
    np.random.seed(9)
    dataset = GroundedScan(
        intransitive_verbs=["walk"], transitive_verbs=["push"],
        adverbs=[], nouns=["circle", "square"],
        color_adjectives=["red", "green"], size_adjectives=["big", "small"],
        percentage_train=0.8, min_object_size=1, max_object_size=4,
        sample_vocabulary="default", save_directory=directory, grid_size=6,
        type_grammar="normal")
    dataset.get_data_pairs(max_examples=300, num_resampling=1,
                           split_type="uniform", make_dev_set=True)
    path = dataset.save_dataset("dataset.txt")
    with open(path) as f:
        data = json.load(f)
    data["examples"]["adverb_1"] = data["examples"]["test"][:12]
    with open(path, "w") as f:
        json.dump(data, f)
    GroundedScanDataset(path, directory, generate_vocabulary=True,
                        backend="engine").save_vocabularies(*VOCABS)
    return path, directory


@pytest.fixture(scope="module")
def jax_native_built():
    if not jax_native.is_available():
        subprocess.run(["bash", os.path.join(ROOT, "scripts",
                                             "build_native.sh")], check=True)
    assert jax_native.is_available()


def load(path, directory, backend, split="train", k=0, dataset=None,
         generate=True):
    ds = GroundedScanDataset(
        path, directory, split=split, input_vocabulary_file=VOCABS[0],
        target_vocabulary_file=VOCABS[1], generate_vocabulary=generate,
        backend=backend, k=k, k_shot_seed=3, dataset=dataset)
    ds.read_dataset()
    return ds


def load_jax(path, directory, split="train", k=0, dataset=None,
             generate=True):
    ds = JaxDataset(path, directory, k=k, split=split,
                    input_vocabulary_file=VOCABS[0],
                    target_vocabulary_file=VOCABS[1],
                    generate_vocabulary=generate, backend="native",
                    dataset=dataset, k_shot_seed=3)
    ds.read_dataset()
    return ds


def assert_same_split(got, want, jax_names=False):
    """Equal examples: arrays, lazy strings, vocabularies."""
    prefix = "_" if jax_names else ""
    assert got.num_examples == want.num_examples > 0
    assert got.input_vocabulary.to_dict() == want.input_vocabulary.to_dict()
    assert got.target_vocabulary.to_dict() == \
        want.target_vocabulary.to_dict()
    assert got.image_channels == want.image_channels
    for name in ("_situations", "_input_lengths", "_target_lengths",
                 "_agent_positions", "_target_positions"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for i in range(got.num_examples):
        np.testing.assert_array_equal(got.input_ids[i],
                                      getattr(want, prefix + "input_ids")[i])
        np.testing.assert_array_equal(got.target_ids[i],
                                      getattr(want, prefix + "target_ids")[i])
        assert got._derivation_representations[i] == \
            want._derivation_representations[i]
        assert got._situation_representations[i] == \
            want._situation_representations[i]


@pytest.mark.parametrize("split", ["train", "dev", "test"])
def test_backends_equal_each_other_and_jax_native(dataset_path,
                                                  jax_native_built, split):
    path, directory = dataset_path
    native = load(path, directory, "native", split)
    engine = load(path, directory, "engine", split)
    assert (native.backend, engine.backend) == ("native", "engine")
    assert isinstance(native.dataset, native_loader.NativeDataset)
    assert_same_split(native, engine)
    assert_same_split(native, load_jax(path, directory, split),
                      jax_names=True)


def test_k_shot_move_equals_across_backends(dataset_path, jax_native_built):
    path, directory = dataset_path
    trains = {b: load(path, directory, b, k=5) for b in ("native", "engine")}
    ref_train = load_jax(path, directory, k=5)
    assert trains["native"].num_examples == \
        len(trains["native"].dataset.splits["train"])
    for split in ("train", "dev", "adverb_1"):
        splits = {b: load(path, directory, "auto", split, dataset=t.dataset,
                          generate=False) if split != "train" else t
                  for b, t in trains.items()}
        ref = ref_train if split == "train" else load_jax(
            path, directory, split, dataset=ref_train._native,
            generate=False)
        assert splits["native"].backend == "native"
        assert splits["engine"].backend == "engine"
        assert_same_split(splits["native"], splits["engine"])
        assert_same_split(splits["native"], ref, jax_names=True)
    assert len(trains["native"].dataset.splits["adverb_1"]) == 7


def test_auto_takes_native_and_falls_back_without_a_compiler(
        dataset_path, monkeypatch, caplog):
    path, directory = dataset_path
    assert load(path, directory, "auto").backend == "native"
    assert native_loader.BUILD_DIR.is_dir() and any(
        native_loader.BUILD_DIR.glob("libgscan_loader_*.so"))
    monkeypatch.setattr(native_loader, "_library", None)
    monkeypatch.setattr(native_loader.shutil, "which", lambda name: None)
    with caplog.at_level(logging.WARNING):
        fallback = load(path, directory, "auto")
    assert fallback.backend == "engine"
    assert sum("native loader cannot be built" in r.getMessage()
               for r in caplog.records) == 1
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        load(path, directory, "native")
    with pytest.raises(ValueError, match="backend must be one of"):
        data_mod.parse_dataset(path, backend="json")
    shared = load(path, directory, "engine")
    with pytest.raises(ValueError, match="parse of backend 'engine'"):
        load(path, directory, "native", "dev", dataset=shared.dataset)


def test_predict_json_bytes_equal_across_backends(dataset_path, tmp_path):
    path, directory = dataset_path
    outputs = []
    for backend in ("native", "engine"):
        data = load(path, directory, backend, "dev", generate=False)
        config = ModelConfig(
            input_vocabulary_size=data.input_vocabulary_size,
            target_vocabulary_size=data.target_vocabulary_size,
            num_cnn_channels=data.image_channels, embedding_dimension=8,
            encoder_hidden_size=12, decoder_hidden_size=12,
            cnn_kernel_size=3, cnn_hidden_num_channels=6)
        params = create_train_state(5, config, Adam(), "cpu").params
        outputs.append(predict_and_save(
            data, params, config, str(tmp_path / "{}.json".format(backend)),
            max_decoding_steps=12, batch_size=16, device="cpu"))
    with open(outputs[0], "rb") as f, open(outputs[1], "rb") as g:
        native_bytes, engine_bytes = f.read(), g.read()
    assert native_bytes == engine_bytes and b'"situation"' in native_bytes


@pytest.mark.parametrize("payload", PAYLOADS)
def test_corrupt_files_raise(tmp_path, payload):
    path = tmp_path / "dataset.txt"
    path.write_text(payload)
    with pytest.raises(ValueError, match="native loader failed"):
        native_loader.NativeDataset(str(path))
