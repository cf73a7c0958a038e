"""Golden-sequence tests for the port's oracle demonstration planner, case
for case the JAX package's tests/test_oracle.py (imports nothing of JAX).

These pin the exact action sequences of the reference implementation
(expectations mirror reference GroundedScan/dataset_test.py:167-333) — the
parity contract for the world simulator and route planner.
"""

import numpy as np
import pytest

from multimodal_seq2seq_gscan_tpu_torch.gscan import (
    GroundedScan, INT_TO_DIR, Object, Position, PositionedObject, Situation)
from multimodal_seq2seq_gscan_tpu_torch.gscan.grammar import Derivation


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    save_dir = str(tmp_path_factory.mktemp("gscan_test"))
    return GroundedScan(
        intransitive_verbs=["walk"], transitive_verbs=["push", "pull"],
        adverbs=["cautiously"], nouns=["circle", "cylinder", "square"],
        color_adjectives=["red", "blue", "green", "yellow"],
        size_adjectives=["big", "small"], percentage_train=0.8,
        min_object_size=1, max_object_size=4, sample_vocabulary="default",
        save_directory=save_dir, grid_size=15, type_grammar="adverb")


def _situation_1():
    return Situation(
        grid_size=15, agent_position=Position(row=7, column=2),
        agent_direction=INT_TO_DIR[0],
        target_object=PositionedObject(
            object=Object(size=2, color="red", shape="circle"),
            position=Position(row=10, column=4), vector=np.array([1, 0, 1])),
        placed_objects=[
            PositionedObject(object=Object(size=2, color="red", shape="circle"),
                             position=Position(row=10, column=4),
                             vector=np.array([1, 0, 1])),
            PositionedObject(object=Object(size=4, color="green", shape="circle"),
                             position=Position(row=3, column=12),
                             vector=np.array([0, 1, 0]))],
        carrying=None)


def _situation_2():
    return Situation(
        grid_size=15, agent_position=Position(row=7, column=2),
        agent_direction=INT_TO_DIR[0],
        target_object=PositionedObject(
            object=Object(size=4, color="red", shape="circle"),
            position=Position(row=10, column=4), vector=np.array([1, 0, 1])),
        placed_objects=[
            PositionedObject(object=Object(size=4, color="red", shape="circle"),
                             position=Position(row=10, column=4),
                             vector=np.array([1, 0, 1])),
            PositionedObject(object=Object(size=4, color="green",
                                           shape="cylinder"),
                             position=Position(row=3, column=12),
                             vector=np.array([0, 1, 0]))],
        carrying=None)


def _situation_3():
    return Situation(
        grid_size=15, agent_position=Position(row=7, column=2),
        agent_direction=INT_TO_DIR[0], target_object=None,
        placed_objects=[
            PositionedObject(object=Object(size=1, color="red", shape="circle"),
                             position=Position(row=10, column=4),
                             vector=np.array([1, 0, 1])),
            PositionedObject(object=Object(size=2, color="green", shape="circle"),
                             position=Position(row=3, column=1),
                             vector=np.array([0, 1, 0]))],
        carrying=None)


def _situation_4():
    return Situation(
        grid_size=15, agent_position=Position(row=7, column=2),
        agent_direction=INT_TO_DIR[0], target_object=None,
        placed_objects=[
            PositionedObject(object=Object(size=2, color="red", shape="circle"),
                             position=Position(row=10, column=4),
                             vector=np.array([1, 0, 1])),
            PositionedObject(object=Object(size=4, color="red", shape="circle"),
                             position=Position(row=3, column=1),
                             vector=np.array([0, 1, 0]))],
        carrying=None)


def _walk_derivation(dataset, adjectives):
    n = len(adjectives)
    rules = ["NP -> NN"] + ["NP -> JJ NP"] * n + [
        "DP -> 'a' NP", "VP -> VV_intrans 'to' DP", "ROOT -> VP"]
    t = dataset._vocabulary.translate_meaning
    jj_part = "NT:" + ":".join("JJ -> {}".format(t(a)) for a in adjectives)
    lexicon = ["T:{}".format(t("walk")),
               "NT:VV_intransitive -> {}".format(t("walk")), "T:to", "T:a"]
    lexicon += ["T:{}".format(t(a)) for a in adjectives]
    if adjectives:
        lexicon.append(jj_part)
    lexicon += ["T:{}".format(t("circle")), "NT:NN -> {}".format(t("circle"))]
    return Derivation.from_str(",".join(rules), ",".join(lexicon),
                               dataset._grammar)


def _push_derivation(dataset, adjective):
    t = dataset._vocabulary.translate_meaning
    rules = "NP -> NN,NP -> JJ NP,DP -> 'a' NP,VP -> VV_trans DP,ROOT -> VP"
    lexicon = "T:{},NT:VV_transitive -> {},T:a,T:{},NT:JJ -> {},T:{},NT:NN -> {}".format(
        t("push"), t("push"), t(adjective), t(adjective), t("circle"), t("circle"))
    return Derivation.from_str(rules, lexicon, dataset._grammar)


def test_demonstrate_push_light(dataset):
    """One push moves a light object one cell."""
    derivation = _push_derivation(dataset, "small")
    expected = "walk,walk,turn right,walk,walk,walk,push,push,push,push"
    actual, _, _ = dataset.demonstrate_command(
        derivation, initial_situation=_situation_1())
    assert expected == ",".join(actual)


def test_demonstrate_push_heavy(dataset):
    """A heavy object needs two pushes per cell of movement."""
    derivation = _push_derivation(dataset, "small")
    expected = ("walk,walk,turn right,walk,walk,walk,"
                "push,push,push,push,push,push,push,push")
    actual, _, _ = dataset.demonstrate_command(
        derivation, initial_situation=_situation_2())
    assert expected == ",".join(actual)


def test_demonstrate_infer_small_target(dataset):
    """Find the small circle when no target is set in the situation."""
    derivation = _walk_derivation(dataset, ["small"])
    expected = "walk,walk,turn right,walk,walk,walk"
    actual, _, _ = dataset.demonstrate_command(
        derivation, initial_situation=_situation_3())
    assert expected == ",".join(actual)


def test_demonstrate_infer_big_target(dataset):
    """Find the big circle when no target is set in the situation."""
    derivation = _walk_derivation(dataset, ["big"])
    expected = "turn left,turn left,walk,turn right,walk,walk,walk,walk"
    actual, _, _ = dataset.demonstrate_command(
        derivation, initial_situation=_situation_3())
    assert expected == ",".join(actual)


def test_demonstrate_disambiguate_by_size(dataset):
    """'small red circle' with two red circles finds the smaller one."""
    derivation = _walk_derivation(dataset, ["red", "small"])
    expected = "walk,walk,turn right,walk,walk,walk"
    actual, _, _ = dataset.demonstrate_command(
        derivation, initial_situation=_situation_4())
    assert expected == ",".join(actual)


def test_demonstrate_ambiguous_referent_fails(dataset):
    """'small red circle' with only one red circle present must fail."""
    derivation = _walk_derivation(dataset, ["red", "small"])
    try:
        actual, _, _ = dataset.demonstrate_command(
            derivation, initial_situation=_situation_3())
    except AssertionError:
        actual = ""
    assert ",".join(actual) == ""


def test_demonstrate_then_replay_light(dataset):
    """Replaying demonstrated commands yields the identical sequence."""
    derivation = _push_derivation(dataset, "small")
    situation = _situation_1()
    actual, _, _ = dataset.demonstrate_command(derivation, situation)
    command = " ".join(derivation.words())
    replayed, _, _, _ = dataset.demonstrate_target_commands(
        command, situation, actual)
    assert ",".join(actual) == ",".join(replayed)


def test_demonstrate_then_replay_heavy(dataset):
    derivation = _push_derivation(dataset, "big")
    situation = _situation_2()
    actual, _, _ = dataset.demonstrate_command(derivation, situation)
    command = " ".join(derivation.words())
    replayed, _, _, _ = dataset.demonstrate_target_commands(
        command, situation, actual)
    assert ",".join(actual) == ",".join(replayed)


def test_find_referred_target(dataset):
    """The logical form extracts the referred target description."""
    derivation = _walk_derivation(dataset, ["red", "small"])
    arguments = []
    derivation.meaning(arguments)
    assert len(arguments) == 1
    target_str, target_predicate = arguments.pop().to_predicate()
    translate = dataset._vocabulary.translate_word
    translated = " ".join(translate(w) for w in target_str.split())
    assert translated == "red circle"
    assert translate(target_predicate["size"]) == "small"
    assert translate(target_predicate["color"]) == "red"
    assert translate(target_predicate["noun"]) == "circle"


def test_generate_possible_targets(dataset):
    expected = {(2, "red", "circle"), (3, "red", "circle"), (4, "red", "circle")}
    actual = set(dataset.generate_possible_targets(
        referred_size="big", referred_color="red", referred_shape="circle"))
    assert actual == expected


def test_derivation_string_roundtrip(dataset):
    derivation, _ = dataset.sample_command()
    derivation_str = repr(derivation)
    rules_str, lexicon_str = derivation_str.split(";")
    new_derivation = Derivation.from_str(rules_str, lexicon_str,
                                         dataset._grammar)
    assert " ".join(new_derivation.words()) == " ".join(derivation.words())


def test_derivation_rules_roundtrip(dataset):
    derivation, _ = dataset.sample_command()
    rules_list = []
    lexicon = {}
    derivation.to_rules(rules_list, lexicon)
    test = Derivation.from_rules(rules_list, lexicon=lexicon)
    assert " ".join(test.words()) == " ".join(derivation.words())


def test_situation_representation_roundtrip():
    situation = _situation_1()
    rep = situation.to_representation()
    recovered = Situation.from_representation(rep)
    assert situation == recovered
    assert recovered.distance_to_target == situation.distance_to_target
    assert recovered.direction_to_target == situation.direction_to_target
