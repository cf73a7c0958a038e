"""The port's GECA augmentation, case for case the JAX package's
tests/test_geca.py: recombined examples are grammatical, oracle-correct,
novel, and the augmented dataset trains (a few CPU steps of the port).
Imports nothing of JAX."""

import os
import random

import numpy as np
import pytest

from multimodal_seq2seq_gscan_tpu_torch.gscan import GroundedScan
from multimodal_seq2seq_gscan_tpu_torch.gscan.geca import (
    GecaAugmenter, decompose, interchangeable_fragments)


@pytest.fixture(scope="module")
def adverb_dataset(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("geca_ds"))
    dataset = GroundedScan(
        intransitive_verbs=["walk"], transitive_verbs=["push"],
        adverbs=["cautiously", "while spinning"],
        nouns=["circle", "square"], color_adjectives=["red", "green"],
        size_adjectives=["big", "small"], percentage_train=0.8,
        min_object_size=1, max_object_size=4, sample_vocabulary="default",
        save_directory=directory, grid_size=6, type_grammar="adverb", seed=5)
    dataset.get_data_pairs(max_examples=300, num_resampling=1,
                           split_type="uniform", make_dev_set=True)
    return dataset, directory


def test_decompose_and_interchangeability():
    commands = [("walk", "to", "a", "red", "circle"),
                ("walk", "to", "a", "green", "circle"),
                ("push", "a", "red", "circle")]
    envs = dict(decompose(commands[0]))
    assert ("walk", "to", "a", "<GAP>", "circle") in envs

    swaps = interchangeable_fragments(commands)
    # 'red' and 'green' share the environment walk to a _ circle.
    assert ("green",) in swaps[("red",)]
    assert ("red",) in swaps[("green",)]


def test_augment_adds_oracle_correct_novel_examples(adverb_dataset):
    dataset, _ = adverb_dataset
    before = dataset.num_examples("train")
    before_keys = {(e["command"], repr(e["situation"]))
                   for e in dataset._data_pairs["train"]}

    augmenter = GecaAugmenter(dataset)
    added = augmenter.augment(max_new=25, rng=random.Random(3))
    assert added > 0
    assert dataset.num_examples("train") == before + added
    assert len(dataset._template_identifiers["train"]) == \
        dataset.num_examples("train")

    for example in dataset._data_pairs["train"][before:]:
        key = (example["command"], repr(example["situation"]))
        assert key not in before_keys  # novel (command, situation) combos
        # parse_example re-demonstrates through the oracle and asserts the
        # stored target_commands match — the strongest correctness check.
        dataset.parse_example(example)


def test_augment_never_duplicates_existing_examples(adverb_dataset):
    """The dedup key must be the RESOLVED situation (what fill_example
    stores), not the donor's: a second augment pass re-proposes the first
    pass's recombinations and must filter every one of them."""
    from multimodal_seq2seq_gscan_tpu_torch.gscan.geca import _situation_key

    dataset, _ = adverb_dataset
    GecaAugmenter(dataset).augment(max_new=10, rng=random.Random(7))
    GecaAugmenter(dataset).augment(max_new=10, rng=random.Random(7))
    keys = [(e["command"], _situation_key(e["situation"]))
            for e in dataset._data_pairs["train"]]
    assert len(keys) == len(set(keys))


@pytest.fixture(scope="module")
def generalization_dataset(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("geca_gen_ds"))
    dataset = GroundedScan(
        intransitive_verbs=["walk"], transitive_verbs=["push", "pull"],
        adverbs=["cautiously", "while spinning"],
        nouns=["circle", "square"], color_adjectives=["red", "yellow"],
        size_adjectives=["big", "small"], percentage_train=0.8,
        min_object_size=1, max_object_size=4, sample_vocabulary="default",
        save_directory=directory, grid_size=6, type_grammar="adverb", seed=9)
    dataset.get_data_pairs(max_examples=600, num_resampling=1,
                           split_type="generalization", make_dev_set=True)
    return dataset


def test_augment_respects_heldout_conditions(generalization_dataset):
    """On a generalization-split dataset, augmented train examples must not
    satisfy any of the 7 held-out conditions (the train-hygiene invariant the
    reference's dataset tests assert, dataset_test.py:696-754) — otherwise
    the held-out evaluations measure leaked training data."""
    from multimodal_seq2seq_gscan_tpu_torch.gscan.types import Situation

    dataset = generalization_dataset
    before = dataset.num_examples("train")
    augmenter = GecaAugmenter(dataset)
    assert augmenter._filter_heldout
    added = augmenter.augment(max_new=30, rng=random.Random(11))
    assert added > 0
    for example in dataset._data_pairs["train"][before:]:
        situation = Situation.from_representation(example["situation"])
        target = situation.target_object.object
        referred = example["referred_target"].split()
        # Default vocabulary: surface form == meaning, so the paper's
        # conditions can be checked on the stored fields directly.
        assert not (target.color == "red" and target.shape == "square")
        assert situation.direction_to_target != "sw"
        assert not ("small" in referred and target.shape == "circle"
                    and target.size == 2)
        assert not (example["verb_in_command"] == "push"
                    and target.shape == "square" and target.size == 3)
        assert example["manner"] != "cautiously"
        assert not (example["verb_in_command"] == "pull"
                    and example["manner"] == "while spinning")
        assert not ("yellow" in referred and target.color == "yellow"
                    and target.shape == "square")


def test_augmented_dataset_saves_loads_and_trains(adverb_dataset, tmp_path):
    import torch

    from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
        GroundedScanDataset)
    from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
    from multimodal_seq2seq_gscan_tpu_torch.train.state import (
        Adam, create_train_state)
    from multimodal_seq2seq_gscan_tpu_torch.train.step import train_step

    dataset, directory = adverb_dataset
    path = dataset.save_dataset("geca_dataset.txt")
    assert os.path.exists(path)

    train_set = GroundedScanDataset(
        path, directory, k=0, split="train",
        input_vocabulary_file="iv.txt", target_vocabulary_file="tv.txt",
        generate_vocabulary=True, backend="engine")
    train_set.read_dataset()
    assert train_set.num_examples == dataset.num_examples("train")

    config = ModelConfig(
        input_vocabulary_size=train_set.input_vocabulary_size,
        target_vocabulary_size=train_set.target_vocabulary_size,
        num_cnn_channels=train_set.image_channels, embedding_dimension=8,
        encoder_hidden_size=16, decoder_hidden_size=16, cnn_kernel_size=3,
        cnn_hidden_num_channels=8,
        input_padding_idx=train_set.input_vocabulary.pad_idx,
        target_pad_idx=train_set.target_vocabulary.pad_idx,
        target_sos_idx=train_set.target_vocabulary.sos_idx,
        target_eos_idx=train_set.target_vocabulary.eos_idx)
    optimizer = Adam()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = create_train_state(0, config, optimizer, "cpu")
        batches = train_set.get_data_iterator(batch_size=16,
                                              pad_to_full_batch=True)
        losses = []
        for _ in range(3):
            batch, _, _, _ = next(batches)
            state, metrics = train_step(state, batch, config, optimizer)
            losses.append(float(metrics["loss"]))
    finally:
        torch.set_num_threads(threads)
    assert state.step == 3
    assert np.isfinite(losses).all()
