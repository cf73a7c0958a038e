"""Split-assignment and generation-invariant tests for the port's dataset
engine, case for case the JAX package's tests/test_splits.py, with the same
seeds passed to the engine's generators (imports nothing of JAX).

Pins the 7 held-out generalization conditions and the k-shot split hygiene
(the reference's test_k_shot_generalization, dataset_test.py:696-754) plus the
target_lengths split predicate.
"""

import numpy as np
import pytest

from multimodal_seq2seq_gscan_tpu_torch.gscan import GroundedScan, Situation


@pytest.fixture(scope="module")
def adverb_dataset(tmp_path_factory):
    """Small generalization-split dataset with adverbs (grid 4 for speed)."""
    directory = str(tmp_path_factory.mktemp("gscan_splits"))
    dataset = GroundedScan(
        intransitive_verbs=["walk"], transitive_verbs=["push", "pull"],
        adverbs=["cautiously", "while spinning", "hesitantly",
                 "while zigzagging"],
        nouns=["circle", "square", "cylinder"],
        color_adjectives=["red", "green", "yellow", "blue"],
        size_adjectives=["big", "small"], percentage_train=0.8,
        min_object_size=1, max_object_size=4, sample_vocabulary="default",
        save_directory=directory, grid_size=4, type_grammar="adverb",
        seed=2)
    dataset.get_data_pairs(max_examples=4000, num_resampling=1,
                           split_type="generalization", make_dev_set=True,
                           k_shot_generalization=5)
    return dataset


def test_visual_split_holds_out_red_squares(adverb_dataset):
    examples = adverb_dataset._data_pairs["visual"]
    assert len(examples) > 0
    for example in examples:
        target = example["situation"]["target_object"]["object"]
        assert target["shape"] == "square" and target["color"] == "red"
    # ... and train has no red-square targets.
    for example in adverb_dataset._data_pairs["train"]:
        target = example["situation"]["target_object"]["object"]
        assert not (target["shape"] == "square" and target["color"] == "red")


def test_situational_1_holds_out_southwest(adverb_dataset):
    examples = adverb_dataset._data_pairs["situational_1"]
    assert len(examples) > 0
    for example in examples:
        assert example["situation"]["direction_to_target"] == "sw"
    for example in adverb_dataset._data_pairs["train"]:
        assert example["situation"]["direction_to_target"] != "sw"


def test_situational_2_small_circle_of_size_two(adverb_dataset):
    for example in adverb_dataset._data_pairs["situational_2"]:
        target = example["situation"]["target_object"]["object"]
        assert target["shape"] == "circle"
        assert target["size"] == "2"
        assert "small" in example["referred_target"]


def test_contextual_push_square_size_three(adverb_dataset):
    for example in adverb_dataset._data_pairs["contextual"]:
        target = example["situation"]["target_object"]["object"]
        assert example["verb_in_command"] == "push"
        assert target["shape"] == "square" and target["size"] == "3"


def test_adverb_splits(adverb_dataset):
    for example in adverb_dataset._data_pairs["adverb_1"]:
        assert example["manner"] == "cautiously"
    for example in adverb_dataset._data_pairs["adverb_2"]:
        assert example["manner"] == "while spinning"
        assert example["verb_in_command"] == "pull"


def test_k_shot_examples_moved_to_train(adverb_dataset):
    """Exactly k cautiously-examples moved into train; the rest excluded."""
    cautious_in_train = [ex for ex in adverb_dataset._data_pairs["train"]
                         if ex["manner"] == "cautiously"]
    assert len(cautious_in_train) == 5
    assert adverb_dataset._k_shot_examples_in_train["adverb_1"] == 5


def test_train_has_no_other_heldout_conditions(adverb_dataset):
    """Train examples (minus the k-shot moves) hit none of the 7 conditions."""
    for example in adverb_dataset._data_pairs["train"]:
        if example["manner"] == "cautiously":
            continue  # the k-shot moves
        splits = adverb_dataset.assign_splits(
            int(example["situation"]["target_object"]["object"]["size"]),
            example["situation"]["target_object"]["object"]["color"],
            example["situation"]["target_object"]["object"]["shape"],
            example["verb_in_command"],
            example["situation"]["direction_to_target"],
            {"size": adverb_dataset._vocabulary.translate_meaning(
                example["referred_target"].split()[0])
             if example["referred_target"].split()[0] in ("small", "big")
             else "",
             "color": "", "noun": ""},
            example["manner"])
        # situational_2 / visual_easier depend on referred_target details
        # checked in their own tests; the structural conditions must be absent.
        assert "visual" not in splits
        assert "situational_1" not in splits
        assert "contextual" not in splits
        assert "adverb_2" not in splits


def test_distance_direction_consistency(adverb_dataset):
    """Stored distance/direction match the situation geometry."""
    for example in adverb_dataset._data_pairs["train"][:200]:
        situation = Situation.from_representation(example["situation"])
        assert situation.distance_to_target == int(
            example["situation"]["distance_to_target"])
        assert situation.direction_to_target == \
            example["situation"]["direction_to_target"]


def test_target_lengths_split(tmp_path):
    dataset = GroundedScan(
        intransitive_verbs=["walk"], transitive_verbs=["push"],
        adverbs=[], nouns=["circle", "square"],
        color_adjectives=["red", "green"], size_adjectives=["big", "small"],
        percentage_train=0.8, min_object_size=1, max_object_size=4,
        sample_vocabulary="default", save_directory=str(tmp_path), grid_size=6,
        type_grammar="normal", seed=3)
    cut_off = 8
    dataset.get_data_pairs(max_examples=600, num_resampling=1,
                           split_type="target_lengths",
                           cut_off_target_length=cut_off)
    assert dataset.num_examples("train") > 0
    assert dataset.num_examples("test") > 0
    for example in dataset._data_pairs["train"]:
        assert len(example["target_commands"].split(",")) <= cut_off
    for example in dataset._data_pairs["test"]:
        assert len(example["target_commands"].split(",")) > cut_off


def test_nonce_vocabulary_roundtrip(tmp_path):
    """Sampled nonce words: generation works and meanings survive save/load."""
    dataset = GroundedScan(
        intransitive_verbs=1, transitive_verbs=2, adverbs=1, nouns=3,
        color_adjectives=4, size_adjectives=2, percentage_train=0.8,
        min_object_size=1, max_object_size=4, sample_vocabulary="sample",
        save_directory=str(tmp_path), grid_size=4, type_grammar="adverb",
        seed=4)
    dataset.get_data_pairs(max_examples=200, num_resampling=1,
                           split_type="uniform")
    path = dataset.save_dataset("nonce.txt")
    loaded = GroundedScan.load_dataset_from_file(path, str(tmp_path))
    n = 0
    for ex1, ex2 in zip(dataset.get_examples_with_image("train", True),
                        loaded.get_examples_with_image("train", True)):
        assert ex1["input_command"] == ex2["input_command"]
        assert ex1["input_meaning"] == ex2["input_meaning"]
        assert ex1["target_command"] == ex2["target_command"]
        assert np.array_equal(ex1["situation_image"], ex2["situation_image"])
        n += 1
    assert n > 0
    # Nonce words differ from their meanings but translate back.
    vocab = dataset._vocabulary
    for noun in vocab.get_nouns():
        assert vocab.translate_word(noun) in {"circle", "square", "cylinder"}
