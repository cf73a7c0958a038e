"""The port's data path against the JAX package's, on the CPU.

- Vocabularies generated from the fixture's train split are written byte
  for byte as the JAX loader writes them, and a test split that generates
  one logs JAX's warning.
- The k-shot move (``k > 0``) takes the examples the JAX loader's default
  backend, the native scanner, takes for one seed: on a copy of the fixture
  whose ``adverb_1`` split is made here from dev examples, the train, dev
  and ``adverb_1`` batches equal JAX's.
- Splits that share one parse (``dataset=``, as ``--mode=test`` shares it
  across ``--splits``) give the batches of splits parsed apart, and JAX's.
- A reference PyTorch checkpoint (a state dict of the reference's names and
  layouts, built and ``torch.save``d here) imports to the params JAX's
  ``load_reference_checkpoint`` gives, leaf for leaf.
- The prefetcher yields the source's batches in order, re-raises the
  source's exception, and an early close stops its producer.
- C.10: ``train`` scores the first ``max_testing_examples`` of a seeded
  permutation of the whole dev split, and with ``None`` all of it, at
  JAX's exact match.
"""

import json
import logging
import os
import subprocess
import threading
import time

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from multimodal_seq2seq_gscan_tpu.data import native_loader
from multimodal_seq2seq_gscan_tpu.data.dataset import (
    GroundedScanDataset as JaxDataset)
from multimodal_seq2seq_gscan_tpu.models import ModelConfig as JaxConfig
from multimodal_seq2seq_gscan_tpu.models import init_model_params
from multimodal_seq2seq_gscan_tpu.models.torch_import import (
    load_reference_checkpoint as jax_load_reference)
from multimodal_seq2seq_gscan_tpu_torch.core.batch import Batch
from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
    GroundedScanDataset)
from multimodal_seq2seq_gscan_tpu_torch.data.prefetch import (
    prefetch_to_device)
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.params import leaves
from multimodal_seq2seq_gscan_tpu_torch.models.torch_import import (
    load_reference_checkpoint)
from tests.test_torch_decode_dtype import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
FIXTURE = os.path.join(ROOT, "data", "bench_fixture")
DATASET = os.path.join(FIXTURE, "dataset.txt")
VOCABS = ("training_input_vocab.txt", "training_target_vocab.txt")


@pytest.fixture(scope="module")
def native():
    """The JAX package's native scanner, built by scripts/build_native.sh
    if it is not (as tests/test_native_loader.py builds it)."""
    if not native_loader.is_available():
        subprocess.run(["bash", os.path.join(ROOT, "scripts",
                                             "build_native.sh")], check=True)
    assert native_loader.is_available()


def batches(dataset, batch_size=16):
    dataset.read_dataset()
    return [(idx, batch) for batch, idx, _, _ in dataset.get_data_iterator(
        batch_size=batch_size, with_representations=False)]


def assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for (idx, batch), (ref_idx, ref_batch) in zip(got, want):
        np.testing.assert_array_equal(idx, ref_idx)
        for name in Batch._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(batch, name)),
                np.asarray(getattr(ref_batch, name)), err_msg=name)


def test_generated_vocabularies_equal_jax_byte_for_byte(native, tmp_path,
                                                       caplog):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    ref = JaxDataset(DATASET, str(jax_dir), k=0, split="train",
                     generate_vocabulary=True, backend="native")
    ref.save_vocabularies(*VOCABS)
    port = GroundedScanDataset(DATASET, str(port_dir), split="train",
                               generate_vocabulary=True)
    port.save_vocabularies(*VOCABS)
    for name in VOCABS:
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes()
    assert port.input_vocabulary_size == ref.input_vocabulary_size > 3
    parsed = port.dataset
    parsed.splits["test"] = parsed.splits["dev"][:8]
    with caplog.at_level(logging.WARNING):
        GroundedScanDataset(DATASET, str(port_dir), split="test",
                            generate_vocabulary=True, dataset=parsed)
    assert any("generating a vocabulary from the test set" in r.getMessage()
               for r in caplog.records)


@pytest.fixture(scope="module")
def adverb_copy(tmp_path_factory):
    """The fixture's first 64 train and 32 dev examples, and an adverb_1
    split of 48 more dev examples, with the fixture's vocabularies."""
    directory = tmp_path_factory.mktemp("adverb_copy")
    with open(DATASET) as f:
        data = json.load(f)
    dev = data["examples"]["dev"]
    data["examples"] = {"train": data["examples"]["train"][:64],
                        "dev": dev[:32], "adverb_1": dev[32:80]}
    with open(directory / "dataset.txt", "w") as f:
        json.dump(data, f)
    for name in VOCABS:
        (directory / name).write_bytes(
            open(os.path.join(FIXTURE, name), "rb").read())
    return str(directory / "dataset.txt"), str(directory)


@pytest.mark.parametrize("seed", [42, 7])
def test_k_shot_move_equals_the_native_backend(native, adverb_copy, seed):
    path, directory = adverb_copy
    ref_train = JaxDataset(path, directory, k=5, split="train",
                           input_vocabulary_file=VOCABS[0],
                           target_vocabulary_file=VOCABS[1],
                           backend="native", k_shot_seed=seed)
    train = GroundedScanDataset(path, directory, split="train", k=5,
                                k_shot_seed=seed)
    for split in ("train", "dev", "adverb_1"):
        if split == "train":
            ref, port = ref_train, train
        else:
            ref = JaxDataset(path, directory, k=0, split=split,
                             input_vocabulary_file=VOCABS[0],
                             target_vocabulary_file=VOCABS[1],
                             dataset=ref_train._native, backend="native")
            port = GroundedScanDataset(path, directory, split=split,
                                       dataset=train.dataset)
        got, want = batches(port), batches(ref)
        assert_same_batches(got, want)
        assert port.num_examples == {"train": 69, "dev": 37,
                                     "adverb_1": 43}[split]


def test_splits_sharing_one_parse_give_the_same_batches(native):
    dev = GroundedScanDataset(DATASET, FIXTURE, split="dev")
    train = GroundedScanDataset(DATASET, FIXTURE, split="train",
                                dataset=dev.dataset)
    assert train.dataset is dev.dataset
    for split, shared in (("dev", dev), ("train", train)):
        alone = GroundedScanDataset(DATASET, FIXTURE, split=split)
        ref = JaxDataset(DATASET, FIXTURE, k=0, split=split,
                         input_vocabulary_file=VOCABS[0],
                         target_vocabulary_file=VOCABS[1], backend="native")
        got = batches(shared, batch_size=512)
        assert_same_batches(got, batches(alone, batch_size=512))
        assert_same_batches(got, batches(ref, batch_size=512))


def reference_state_dict(jax_params, seed):
    """A reference ``Model`` state dict whose values are random and whose
    names and layouts are the reference's, from a JAX params tree's shapes
    (JAX's mapping inverted: Linear [out, in], conv [O, C, kh, kw], LSTM
    [4H, in] with ``_reverse`` for the backward direction)."""
    rng = np.random.RandomState(seed)

    def draw(shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    sd = {}
    cnn = jax_params.cnn
    for i, (w, b) in enumerate(((cnn.conv1_w, cnn.conv1_b),
                                (cnn.conv5_w, cnn.conv5_b),
                                (cnn.convk_w, cnn.convk_b))):
        sd["situation_encoder.conv_{}.weight".format(i + 1)] = draw(
            w.shape[::-1])
        sd["situation_encoder.conv_{}.bias".format(i + 1)] = draw(b.shape)

    def lstm(prefix, layers, suffix=""):
        for i, layer in enumerate(layers):
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                field = {"weight_ih": "w_ih", "weight_hh": "w_hh",
                         "bias_ih": "b_ih", "bias_hh": "b_hh"}[name]
                sd["{}.{}_l{}{}".format(prefix, name, i, suffix)] = draw(
                    getattr(layer, field).shape)

    sd["encoder.embedding.weight"] = draw(jax_params.encoder.embedding.shape)
    lstm("encoder.lstm", jax_params.encoder.fwd_layers)
    lstm("encoder.lstm", jax_params.encoder.bwd_layers, "_reverse")
    sd["enc_hidden_to_dec_hidden.weight"] = draw(
        jax_params.enc_to_dec_w.shape[::-1])
    sd["enc_hidden_to_dec_hidden.bias"] = draw(jax_params.enc_to_dec_b.shape)
    for prefix in ("textual_attention", "visual_attention"):
        attention = getattr(jax_params, prefix)
        for name in ("key", "query", "energy"):
            sd["{}.{}_layer.weight".format(prefix, name)] = draw(
                getattr(attention, name + "_w").shape[::-1])
    dec = jax_params.decoder
    sd["attention_decoder.embedding.weight"] = draw(dec.embedding.shape)
    lstm("attention_decoder.lstm", dec.lstm_layers)
    sd["attention_decoder.queries_to_keys.weight"] = draw(
        dec.queries_to_keys_w.shape[::-1])
    sd["attention_decoder.queries_to_keys.bias"] = draw(
        dec.queries_to_keys_b.shape)
    sd["attention_decoder.output_to_hidden.weight"] = draw(
        dec.output_to_hidden_w.shape[::-1])
    sd["attention_decoder.hidden_to_output.weight"] = draw(
        dec.hidden_to_output_w.shape[::-1])
    return sd


def test_reference_checkpoint_imports_as_jax(tmp_path):
    kwargs = dict(input_vocabulary_size=11, target_vocabulary_size=7,
                  num_cnn_channels=5, embedding_dimension=6,
                  encoder_hidden_size=8, decoder_hidden_size=8,
                  num_encoder_layers=2, num_decoder_layers=2,
                  cnn_kernel_size=3, cnn_hidden_num_channels=4)
    jax_config = JaxConfig(**kwargs)
    shapes = jax.eval_shape(lambda key: init_model_params(key, jax_config),
                            jax.random.PRNGKey(0))
    path = str(tmp_path / "checkpoint.pth.tar")
    torch.save({"state_dict": reference_state_dict(shapes, 3),
                "iteration": 700, "best_iteration": 600,
                "best_accuracy": 91.5, "best_exact_match": 80.25}, path)
    ref, ref_meta = jax_load_reference(path, jax_config)
    params, meta = load_reference_checkpoint(path, ModelConfig(**kwargs),
                                             device="cpu")
    assert meta == ref_meta and meta["iteration"] == 700
    ref_leaves = jax.tree.leaves(ref)
    assert len(leaves(params)) == len(ref_leaves) == 44
    for got, want in zip(leaves(params), ref_leaves):
        assert got.is_contiguous() and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert flax.serialization.to_state_dict(ref).keys() == \
        set(type(params)._fields)


def test_prefetch_keeps_order_reraises_and_stops_on_close():
    produced = []

    def source():
        for i in range(1000):
            produced.append(i)
            yield (Batch(*(torch.full((2,), i) for _ in Batch._fields)), i)

    stream = prefetch_to_device(source(), depth=3, device="cpu")
    seen = [next(stream)[1] for _ in range(5)]
    assert seen == list(range(5))
    stream.close()
    deadline = time.time() + 10
    while time.time() < deadline and any(
            t.name == "batch-prefetch" and t.is_alive()
            for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == "batch-prefetch" and t.is_alive()
                   for t in threading.enumerate())
    assert len(produced) <= 5 + 3 + 2  # depth ahead, one in hand, one put

    def failing():
        yield (Batch(*(torch.zeros(1) for _ in Batch._fields)), 0)
        raise RuntimeError("source failed")

    stream = prefetch_to_device(failing(), depth=2, device="cpu")
    assert next(stream)[1] == 0
    with pytest.raises(RuntimeError, match="source failed"):
        next(stream)
    assert [item[1] for item in prefetch_to_device(
        iter([(Batch(*(torch.zeros(1) for _ in Batch._fields)), i)
              for i in range(7)]), device="cpu")] == list(range(7))


def test_dev_subset_is_a_seeded_permutation(native, adverb_copy, tmp_path,
                                            monkeypatch):
    """C.10: ``train`` reads the whole dev split and scores the first
    ``max_testing_examples`` of ``default_rng(seed).permutation`` (JAX
    scores the first of an unseeded shuffle); with ``None`` it scores all of
    dev, and the exact match equals JAX's ``evaluate`` of the checkpoint it
    wrote, on the dev split in file order."""
    from multimodal_seq2seq_gscan_tpu.decode.predict import (
        evaluate as jax_evaluate)
    from multimodal_seq2seq_gscan_tpu_torch.decode import predict
    from multimodal_seq2seq_gscan_tpu_torch.train.checkpoint import (
        read_checkpoint)
    from multimodal_seq2seq_gscan_tpu_torch.train.loop import train
    path, directory = adverb_copy
    records, scored = predict._records, []

    def spy(*args, **kwargs):
        for record in records(*args, **kwargs):
            scored.append(record["example_idx"])
            yield record

    monkeypatch.setattr(predict, "_records", spy)

    def evaluated(out, max_testing_examples):
        """One streamed step from the fixture's checkpoint (step 200000),
        then its evaluation: (exact match, the examples scored)."""
        events, scored[:] = [], []
        train(path, directory, output_directory=str(tmp_path / out),
              resume_from_file=os.path.join(FIXTURE, "model_best.msgpack"),
              max_training_iterations=200000, print_every=1000,
              evaluate_every=1000, steps_per_execution=1,
              training_batch_size=8, max_testing_examples=max_testing_examples,
              evaluation_batch_size=16, seed=5, device="cpu",
              callback=lambda *event: events.append(event))
        assert [e[:2] for e in events] == [("train", 200000),
                                           ("eval", 200000)]
        return events[1][2]["exact_match"], list(scored)

    order = np.random.default_rng(5).permutation(32).tolist()
    _, subset = evaluated("subset", 12)
    assert subset == order[:12]
    exact_match, every = evaluated("all", None)
    assert every == order
    dev = JaxDataset(path, directory, k=0, split="dev",
                     input_vocabulary_file=VOCABS[0],
                     target_vocabulary_file=VOCABS[1], backend="native")
    dev.read_dataset()
    config = JaxConfig(input_vocabulary_size=dev.input_vocabulary_size,
                       target_vocabulary_size=dev.target_vocabulary_size,
                       num_cnn_channels=dev.image_channels)
    template = jax.eval_shape(lambda key: init_model_params(key, config),
                              jax.random.PRNGKey(0))
    params = flax.serialization.from_state_dict(template, read_checkpoint(
        str(tmp_path / "all" / "checkpoint.msgpack"))["params"])
    _, ref_exact_match, _ = jax_evaluate(dev, params, config,
                                         max_decoding_steps=120,
                                         batch_size=16)
    assert exact_match == ref_exact_match > 50.0
