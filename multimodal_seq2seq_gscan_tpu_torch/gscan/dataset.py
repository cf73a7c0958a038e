"""The gSCAN dataset orchestrator: generation, splits, (de)serialization, stats.

Re-implements the capabilities of the reference ``GroundedScan`` class
(GroundedScan/dataset.py:22-1413) on top of the dependency-free world simulator:

- pairing every grammar derivation with every relevant situation and
  demonstrating the oracle action sequence;
- the 7 held-out generalization conditions (``assign_splits``);
- uniform / generalization / target_lengths split types;
- ``dataset.txt`` JSON wire format (byte-compatible);
- k-shot moves of adverb_1 examples into train;
- per-split statistics files.

The example-loading path (``get_examples_with_image``) uses the vectorized
sparse->dense encoder instead of re-simulating each situation through the world
(golden-tested equal), which turns the reference's ~57-minute load into seconds.
"""

import itertools
import json
import logging
import os
import random
from collections import Counter, defaultdict
from copy import deepcopy
from typing import Dict, List, Tuple, Union

import numpy as np

from multimodal_seq2seq_gscan_tpu_torch.gscan.grammar import Derivation, Grammar
from multimodal_seq2seq_gscan_tpu_torch.gscan.object_vocabulary import ObjectVocabulary
from multimodal_seq2seq_gscan_tpu_torch.gscan.types import (
    EVENT, Object, Position, Situation, topo_sort)
from multimodal_seq2seq_gscan_tpu_torch.gscan.vocabulary import Vocabulary
from multimodal_seq2seq_gscan_tpu_torch.gscan.world import World
from multimodal_seq2seq_gscan_tpu_torch.gscan.encode import (
    encode_situation_from_representation)

logger = logging.getLogger(__name__)


class GroundedScan:
    """A dataset for systematic generalization in language, grounded in a gridworld."""

    def __init__(self, intransitive_verbs: Union[Dict[str, str], List[str], int],
                 transitive_verbs: Union[Dict[str, str], List[str], int],
                 adverbs: Union[Dict[str, str], List[str], int],
                 nouns: Union[Dict[str, str], List[str], int],
                 color_adjectives: Union[Dict[str, str], List[str], int],
                 size_adjectives: Union[Dict[str, str], List[str], int],
                 grid_size: int, min_object_size: int, max_object_size: int,
                 type_grammar: str, sample_vocabulary: str,
                 percentage_train: float, percentage_dev: float = 0.01,
                 save_directory: str = os.getcwd(), max_recursion: int = 1,
                 seed: int = 1):
        """Every draw of the engine comes from two generators made from
        ``seed``: ``random.Random(seed)`` and ``np.random.RandomState(seed)``
        (the streams ``random.seed(seed)`` and ``np.random.seed(seed)`` give
        the module-level functions)."""
        if sample_vocabulary == "sample":
            needed_type = int
        elif sample_vocabulary == "load":
            needed_type = dict
        elif sample_vocabulary == "default":
            needed_type = list
        else:
            raise ValueError("Unknown value specified for sample_vocabulary: "
                             "{}".format(sample_vocabulary))
        assert all(isinstance(x, needed_type) for x in
                   (intransitive_verbs, transitive_verbs, adverbs, nouns,
                    color_adjectives, size_adjectives)), (
            "please specify correct flags for words for --sample_vocabulary="
            "{}.".format(sample_vocabulary))

        self.save_directory = save_directory
        self._rng = random.Random(seed)
        self._np_rng = np.random.RandomState(seed)

        if sample_vocabulary == "default":
            self._vocabulary = Vocabulary.initialize(
                intransitive_verbs=intransitive_verbs,
                transitive_verbs=transitive_verbs, adverbs=adverbs, nouns=nouns,
                color_adjectives=color_adjectives, size_adjectives=size_adjectives)
        elif sample_vocabulary == "sample":
            self._vocabulary = Vocabulary.sample(
                num_intransitive=intransitive_verbs,
                num_transitive=transitive_verbs, num_adverbs=adverbs,
                num_nouns=nouns, num_color_adjectives=color_adjectives,
                num_size_adjectives=size_adjectives, rng=self._rng)
        else:  # load
            self._vocabulary = Vocabulary(
                intransitive_verbs=intransitive_verbs,
                transitive_verbs=transitive_verbs, adverbs=adverbs, nouns=nouns,
                color_adjectives=color_adjectives, size_adjectives=size_adjectives)

        self._object_vocabulary = ObjectVocabulary(
            shapes=self._vocabulary.get_semantic_shapes(),
            colors=self._vocabulary.get_semantic_colors(),
            min_size=min_object_size, max_size=max_object_size,
            rng=self._rng)

        self._world = World(grid_size=grid_size,
                            colors=self._vocabulary.get_semantic_colors(),
                            object_vocabulary=self._object_vocabulary,
                            shapes=self._vocabulary.get_semantic_shapes(),
                            save_directory=self.save_directory,
                            rng=self._rng)
        self._relative_directions = {"n", "e", "s", "w", "ne", "se", "sw", "nw"}
        self._straight_directions = {"n", "e", "s", "w"}
        self._combined_directions = {"ne", "se", "sw", "nw"}

        self._type_grammar = type_grammar
        self.max_recursion = max_recursion
        self._grammar = Grammar(vocabulary=self._vocabulary,
                                type_grammar=type_grammar,
                                max_recursion=max_recursion,
                                np_rng=self._np_rng)

        self._percentage_train = percentage_train
        self._percentage_dev = percentage_dev
        self._possible_splits = ["train", "dev", "test", "visual",
                                 "situational_1", "situational_2", "contextual",
                                 "adverb_1", "adverb_2", "visual_easier",
                                 "target_lengths"]
        self._data_pairs = self.get_empty_split_dict()
        self._template_identifiers = self.get_empty_split_dict()
        self._examples_to_visualize = []
        self._k_shot_examples_in_train = Counter()
        self._data_statistics = {split: self.get_empty_data_statistics()
                                 for split in self._possible_splits}

    # ------------------------------------------------------------------
    # Split bookkeeping
    # ------------------------------------------------------------------

    def reset_dataset(self):
        self._grammar.reset_grammar()
        self._data_pairs = self.get_empty_split_dict()
        self._template_identifiers = self.get_empty_split_dict()
        self._examples_to_visualize.clear()
        self._data_statistics = {split: self.get_empty_data_statistics()
                                 for split in self._possible_splits}

    def get_empty_split_dict(self):
        return {split: [] for split in self._possible_splits}

    def make_test_set(self, type_set: str, percentage: float):
        """Move a random percentage of train examples into ``type_set``."""
        num_examples = int(percentage * len(self._data_pairs["train"]))
        k_random_indices = self._rng.sample(
            range(len(self._data_pairs["train"])), k=num_examples)
        for example_idx in k_random_indices:
            self._data_pairs[type_set].append(
                deepcopy(self._data_pairs["train"][example_idx]))
            self._template_identifiers[type_set].append(
                self._template_identifiers["train"][example_idx])
        for example_idx in sorted(k_random_indices, reverse=True):
            del self._data_pairs["train"][example_idx]
            del self._template_identifiers["train"][example_idx]

    def move_k_examples_to_train(self, k: int, split: str):
        if len(self._data_pairs[split]) < k + 1:
            logger.info("Not enough examples in split {} for k(k={})-shot "
                        "generalization".format(split, k))
        k_random_indices = self._rng.sample(range(len(self._data_pairs[split])),
                                          k=k)
        for example_idx in k_random_indices:
            self._data_pairs["train"].append(
                deepcopy(self._data_pairs[split][example_idx]))
            self._template_identifiers["train"].append(
                self._template_identifiers[split][example_idx])
            self._k_shot_examples_in_train[split] += 1
        for example_idx in sorted(k_random_indices, reverse=True):
            del self._data_pairs[split][example_idx]
            del self._template_identifiers[split][example_idx]

    def num_examples(self, split="train") -> int:
        return len(self._data_pairs[split])

    # ------------------------------------------------------------------
    # Example iteration (the ML-pipeline entry point)
    # ------------------------------------------------------------------

    def get_examples_with_image(self, split: str = "train",
                                simple_situation_representation: bool = False):
        """Yield examples with their dense grid (or RGB) situation tensor.

        Fast path: the dense grid is vectorized straight from the serialized
        situation (no world re-simulation) — identical output, golden-tested.
        """
        for example in self._data_pairs[split]:
            command = self.parse_command_repr(example["command"])
            meaning = example.get("meaning") or example["command"]
            meaning = self.parse_command_repr(meaning)
            if simple_situation_representation:
                situation_image = encode_situation_from_representation(
                    example["situation"], grid_size=self._world.grid_size)
            else:
                situation = Situation.from_representation(example["situation"])
                self._world.clear_situation()
                self.initialize_world(situation)
                situation_image = self.render_current_situation_rgb()
            target_commands = self.parse_command_repr(example["target_commands"])
            yield {"input_command": command, "input_meaning": meaning,
                   "derivation_representation": example.get("derivation"),
                   "situation_image": situation_image,
                   "situation_representation": example["situation"],
                   "target_command": target_commands}

    def render_current_situation_rgb(self) -> np.ndarray:
        from multimodal_seq2seq_gscan_tpu_torch.analysis.render import render_situation
        return render_situation(self._world.get_current_situation())

    @property
    def situation_image_dimension(self) -> int:
        return self.render_current_situation_rgb().shape[0]

    # ------------------------------------------------------------------
    # Example equivalence / dedup
    # ------------------------------------------------------------------

    @staticmethod
    def compare_examples(example_1: dict, example_2: dict) -> bool:
        """Same command, same target commands, same target position."""
        if example_1["command"] != example_2["command"]:
            return False
        if example_1["target_commands"] != example_2["target_commands"]:
            return False
        pos_1 = example_1["situation"]["target_object"]["position"]
        pos_2 = example_2["situation"]["target_object"]["position"]
        return pos_1["row"] == pos_2["row"] and pos_1["column"] == pos_2["column"]

    @staticmethod
    def _example_equivalence_key(example: dict, template_identifier):
        target_pos = example["situation"]["target_object"]["position"]
        return (template_identifier, example["command"],
                example["target_commands"], target_pos["row"],
                target_pos["column"])

    def count_equivalent_examples(self, split_1="train", split_2="test") -> int:
        keys_1 = Counter(
            self._example_equivalence_key(example, identifier)
            for example, identifier in zip(self._data_pairs[split_1],
                                           self._template_identifiers[split_1]))
        return sum(keys_1[self._example_equivalence_key(example, identifier)]
                   for example, identifier in zip(self._data_pairs[split_2],
                                                  self._template_identifiers[split_2]))

    def discard_equivalent_examples(self, split="test") -> int:
        """Drop examples from ``split`` that are equivalent to a train example.

        Hash-join on (template, command, target commands, target position) —
        O(n + m) instead of the reference's O(n*m) scan, same result.
        """
        train_keys = {
            self._example_equivalence_key(example, identifier)
            for example, identifier in zip(self._data_pairs["train"],
                                           self._template_identifiers["train"])}
        to_delete = [
            i for i, (example, identifier) in enumerate(
                zip(self._data_pairs[split], self._template_identifiers[split]))
            if self._example_equivalence_key(example, identifier) in train_keys]
        for i in sorted(to_delete, reverse=True):
            del self._data_pairs[split][i]
            del self._template_identifiers[split][i]
        return len(to_delete)

    def has_equivalent_example(self, example: dict, template_identifier,
                               split="train") -> bool:
        key = self._example_equivalence_key(example, template_identifier)
        return any(self._example_equivalence_key(e, t) == key
                   for e, t in zip(self._data_pairs[split],
                                   self._template_identifiers[split]))

    # ------------------------------------------------------------------
    # Example construction
    # ------------------------------------------------------------------

    def meaning_command(self, input_command: List[str]) -> List[str]:
        return [self._vocabulary.translate_word(w) for w in input_command]

    def fill_example(self, command: List[str], derivation: Derivation,
                     situation: Situation, target_commands: List[str],
                     verb_in_command: str, target_predicate: dict,
                     visualize: bool, adverb: str, splits: List[str]) -> dict:
        example = {
            "command": self.command_repr(command),
            "meaning": self.command_repr(self.meaning_command(command)),
            "derivation": self.derivation_repr(derivation),
            "situation": situation.to_representation(),
            "target_commands": self.command_repr(target_commands),
            "verb_in_command": self._vocabulary.translate_word(verb_in_command),
            "manner": self._vocabulary.translate_word(adverb),
            "referred_target": " ".join([
                self._vocabulary.translate_word(target_predicate["size"]),
                self._vocabulary.translate_word(target_predicate["color"]),
                self._vocabulary.translate_word(target_predicate["noun"])]),
        }
        for split in splits:
            self._data_pairs[split].append(example)
        if visualize:
            self._examples_to_visualize.append(example)
        return example

    def parse_example(self, data_example: dict):
        """Parse a serialized example and re-demonstrate it (validation path)."""
        command = self.parse_command_repr(data_example["command"])
        meaning = self.parse_command_repr(data_example["meaning"])
        situation = Situation.from_representation(data_example["situation"])
        target_commands = self.parse_command_repr(data_example["target_commands"])
        derivation = self.parse_derivation_repr(data_example["derivation"])
        assert self.derivation_repr(derivation) == data_example["derivation"]
        actual_target_commands, target_demonstration, action = \
            self.demonstrate_command(derivation, situation)
        assert self.command_repr(actual_target_commands) == self.command_repr(
            target_commands)
        return (command, meaning, derivation, situation, actual_target_commands,
                target_demonstration, action)

    # ------------------------------------------------------------------
    # Oracle demonstration
    # ------------------------------------------------------------------

    def demonstrate_target_commands(
            self, command: str, initial_situation: Situation,
            target_commands: List[str]) -> Tuple[List[str], List[Situation],
                                                 int, int]:
        """Replay a sequence of action commands from ``initial_situation``."""
        current_situation = self._world.get_current_situation()
        current_mission = self._world.mission
        self.initialize_world(initial_situation, mission=command)
        for target_command in target_commands:
            self._world.execute_command(target_command)
        target_commands, target_demonstration = \
            self._world.get_current_observations()
        end_column, end_row = self._world.agent_pos
        self._world.clear_situation()
        self.initialize_world(current_situation, mission=current_mission)
        return target_commands, target_demonstration, end_column, end_row

    def demonstrate_command(self, derivation: Derivation,
                            initial_situation: Situation) -> Tuple[List[str],
                                                                   List[Situation],
                                                                   str]:
        """Oracle: walk to (and optionally push/pull) the derivation's target."""
        command = " ".join(derivation.words())
        arguments = []
        logical_form = derivation.meaning(arguments)
        current_situation = self._world.get_current_situation()
        current_mission = self._world.mission

        self.initialize_world(initial_situation, mission=command)

        events = [v for v in logical_form.variables if v.sem_type == EVENT]
        seq_constraints = [t.arguments for t in logical_form.terms
                           if t.function == "seq"]
        ordered_events = topo_sort(events, seq_constraints)

        action = None
        for event in ordered_events:
            sub_logical_form = logical_form.select([event], exclude={"seq"})
            event_lf = sub_logical_form.select([event], exclude={"patient"})
            args = [t.arguments[1] for t in sub_logical_form.terms
                    if t.function == "patient"]

            is_transitive = False
            if event_lf.head.sem_type == EVENT:
                for term in event_lf.terms:
                    if term.specs.action:
                        action = term.specs.action
                        is_transitive = term.specs.is_transitive

            # NB: the manner is the surface adverb word (not translated) — manner
            # transforms only fire when surface == semantic, as in the reference.
            manner = [t.specs.manner for t in event_lf.terms if t.specs.manner]
            manner = manner.pop() if manner else None
            assert len(args) <= 1, ("Only one target object supported, but two "
                                    "arguments parsed in a derivation.")
            if len(args) > 0:
                arg_logical_form = sub_logical_form.select([args[0]])
                object_str, object_predicate = arg_logical_form.to_predicate()

                if not initial_situation.target_object:
                    translated_object_str = " ".join(
                        self._vocabulary.translate_word(w)
                        for w in object_str.split())
                    translated_object_size = self._vocabulary.translate_word(
                        object_predicate["size"])
                    if self._world.has_object(translated_object_str):
                        object_locations = self._world.object_positions(
                            translated_object_str,
                            object_size=translated_object_size or None)
                    else:
                        object_locations = []
                else:
                    object_locations = [initial_situation.target_object.position]

                if len(object_locations) > 1:
                    logger.info("WARNING: {} possible target locations.".format(
                        len(object_locations)))
                if not object_locations:
                    continue
                goal = self._rng.sample(list(object_locations), 1).pop()
                if not is_transitive:
                    primitive_command = self._vocabulary.translate_word(action)
                else:
                    primitive_command = "walk"

                self._world.go_to_position(position=goal, manner=manner,
                                           primitive_command=primitive_command)

                if is_transitive:
                    semantic_action = self._vocabulary.translate_word(action)
                    self._world.move_object_to_wall(action=semantic_action,
                                                    manner=manner)

        target_commands, target_demonstration = \
            self._world.get_current_observations()
        self._world.clear_situation()
        self.initialize_world(current_situation, mission=current_mission)
        return target_commands, target_demonstration, action

    def initialize_world(self, situation: Situation, mission: str = ""):
        objects = [(po.object, po.position) for po in situation.placed_objects]
        self._world.initialize(objects, agent_position=situation.agent_pos,
                               agent_direction=situation.agent_direction,
                               target_object=situation.target_object,
                               carrying=situation.carrying)
        if mission:
            self._world.set_mission(mission)

    # ------------------------------------------------------------------
    # Situation generation
    # ------------------------------------------------------------------

    def generate_possible_targets(self, referred_size: str, referred_color: str,
                                  referred_shape: str):
        """All (size, color, shape) objects a referring expression could denote."""
        if referred_size:
            if referred_size == "small":
                target_sizes = self._object_vocabulary.object_sizes[:-1]
            elif referred_size == "big":
                target_sizes = self._object_vocabulary.object_sizes[1:]
            else:
                raise ValueError("Unknown size adjective in command.")
        else:
            target_sizes = self._object_vocabulary.object_sizes
        target_colors = ([referred_color] if referred_color
                         else self._object_vocabulary.object_colors)
        return list(itertools.product(target_sizes, target_colors,
                                      [referred_shape]))

    def all_objects_except_shape(self, shape: str) -> List[tuple]:
        all_shapes = self._object_vocabulary.object_shapes
        all_shapes.remove(shape)
        return list(itertools.product(self._object_vocabulary.object_sizes,
                                      self._object_vocabulary.object_colors,
                                      all_shapes))

    def get_larger_sizes(self, size: int) -> List[int]:
        return list(range(size + 1, self._object_vocabulary.largest_size + 1))

    def get_smaller_sizes(self, size: int) -> List[int]:
        return list(range(self._object_vocabulary.smallest_size, size))

    def generate_distinct_objects(self, referred_size: str, referred_color: str,
                                  referred_shape: str, actual_size: int,
                                  actual_color: str) -> Tuple[list, list]:
        """Distractor groups + obligatory objects keeping the referent unique.

        Returns (groups, obligatory): each group is a list of objects that get
        placed together when sampled; obligatory objects are always placed
        (e.g. a larger circle must exist when referring to 'the small circle').
        """
        objects = []
        obligatory_objects = []
        if not referred_size and not referred_color:
            all_shapes = self._object_vocabulary.object_shapes
            all_shapes.remove(referred_shape)
            for shape in all_shapes:
                objects.append([(self._object_vocabulary.sample_size(),
                                 self._object_vocabulary.sample_color(), shape)])
            return objects, obligatory_objects
        elif not referred_size:
            for shape in self._object_vocabulary.object_shapes:
                for color in self._object_vocabulary.object_colors:
                    if not (shape == referred_shape and color == referred_color):
                        objects.append([(self._object_vocabulary.sample_size(),
                                         color, shape)])
            return objects, obligatory_objects
        else:
            if referred_size == "small":
                all_other_sizes = self.get_larger_sizes(actual_size)
            elif referred_size == "big":
                all_other_sizes = self.get_smaller_sizes(actual_size)
            else:
                raise ValueError("Unknown referred size in command")
            all_other_shapes = self._object_vocabulary.object_shapes
            all_other_shapes.remove(referred_shape)
            if not referred_color:
                for shape in self._object_vocabulary.object_shapes:
                    for color in self._object_vocabulary.object_colors:
                        if not shape == referred_shape:
                            objects.append([
                                (self._object_vocabulary.sample_size(), color,
                                 shape) for _ in range(2)])
                        else:
                            if not color == actual_color:
                                objects.append([
                                    (self._rng.choice(all_other_sizes), color,
                                     shape) for _ in range(2)])
                            else:
                                obligatory_objects.append(
                                    (self._rng.choice(all_other_sizes), color,
                                     shape))
                return objects, obligatory_objects
            else:
                for shape in self._object_vocabulary.object_shapes:
                    for color in self._object_vocabulary.object_colors:
                        if not (shape == referred_shape
                                and color == referred_color):
                            objects.append([
                                (self._object_vocabulary.sample_size(), color,
                                 shape) for _ in range(2)])
                        else:
                            obligatory_objects.append(
                                (self._rng.choice(all_other_sizes), color,
                                 shape))
                return objects, obligatory_objects

    @staticmethod
    def get_empty_situation():
        return {
            "distance_to_target": None,
            "direction_to_target": None,
            "target_shape": None,
            "target_color": None,
            "target_size": None,
            "target_position": None,
            "agent_position": None,
        }

    def generate_situations(self, num_resampling: int = 1):
        """All semantically distinct (target object x direction x distance) specs."""
        all_targets = itertools.product(
            self._object_vocabulary.object_sizes,
            self._object_vocabulary.object_colors,
            self._object_vocabulary.object_shapes)
        situation_specifications = {}
        for target_size, target_color, target_shape in all_targets:
            specs_list = situation_specifications.setdefault(
                target_shape, {}).setdefault(target_color, {}).setdefault(
                target_size, [])

            for direction_str in self._relative_directions:
                if direction_str in self._straight_directions:
                    for num_steps_to_target in range(1, self._world.grid_size):
                        if 1 < num_steps_to_target < self._world.grid_size - 1:
                            num_to_resample = num_resampling
                        else:
                            num_to_resample = 1
                        for _ in range(num_to_resample):
                            empty_situation = self.get_empty_situation()
                            target_position = Position(
                                column=self._world.grid_size + 1,
                                row=self._world.grid_size + 1)
                            while not self._world.within_grid(target_position):
                                condition = {"n": 0, "e": 0, "s": 0, "w": 0}
                                condition[direction_str] = num_steps_to_target
                                agent_position = \
                                    self._world.sample_position_conditioned(
                                        *condition.values())
                                target_position = self._world.get_position_at(
                                    agent_position, direction_str,
                                    num_steps_to_target)
                            empty_situation["agent_position"] = agent_position
                            empty_situation["target_position"] = target_position
                            empty_situation["distance_to_target"] = \
                                num_steps_to_target
                            empty_situation["direction_to_target"] = direction_str
                            empty_situation["target_shape"] = target_shape
                            empty_situation["target_color"] = target_color
                            empty_situation["target_size"] = target_size
                            specs_list.append(empty_situation)
                else:
                    max_combined = 2 * (self._world.grid_size - 1)
                    for number_of_steps in range(2, max_combined + 1):
                        if 1 < number_of_steps < max_combined:
                            num_to_resample = num_resampling
                        else:
                            num_to_resample = 1
                        for _ in range(num_to_resample):
                            empty_situation = self.get_empty_situation()
                            random_divide = self._rng.randint(
                                max(1, number_of_steps - self._world.grid_size + 1),
                                min(number_of_steps - 1,
                                    self._world.grid_size - 1))
                            steps_first = random_divide
                            steps_second = number_of_steps - random_divide
                            directions = list(direction_str)
                            target_position = Position(
                                column=self._world.grid_size + 1,
                                row=self._world.grid_size + 1)
                            while not self._world.within_grid(target_position):
                                condition = {"n": 0, "e": 0, "s": 0, "w": 0}
                                condition[directions[0]] = steps_first
                                condition[directions[1]] = steps_second
                                agent_position = \
                                    self._world.sample_position_conditioned(
                                        *condition.values())
                                intermediate = self._world.get_position_at(
                                    agent_position, directions[0], steps_first)
                                target_position = self._world.get_position_at(
                                    intermediate, directions[1], steps_second)
                            empty_situation["agent_position"] = agent_position
                            empty_situation["target_position"] = target_position
                            empty_situation["distance_to_target"] = \
                                number_of_steps
                            empty_situation["direction_to_target"] = direction_str
                            empty_situation["target_shape"] = target_shape
                            empty_situation["target_color"] = target_color
                            empty_situation["target_size"] = target_size
                            specs_list.append(empty_situation)
        return situation_specifications

    def initialize_world_from_spec(self, situation_spec, referred_size: str,
                                   referred_color: str, referred_shape: str,
                                   actual_size: int,
                                   sample_percentage: float = 0.5,
                                   min_other_objects: int = 0):
        self._world.clear_situation()
        self._world.place_agent_at(situation_spec["agent_position"])
        target_shape = situation_spec["target_shape"]
        target_color = situation_spec["target_color"]
        target_size = situation_spec["target_size"]
        self._world.place_object(
            Object(size=target_size, color=target_color, shape=target_shape),
            position=situation_spec["target_position"], target=True)
        distinct_objects, obligatory_objects = self.generate_distinct_objects(
            referred_size=self._vocabulary.translate_word(referred_size),
            referred_color=self._vocabulary.translate_word(referred_color),
            referred_shape=self._vocabulary.translate_word(referred_shape),
            actual_size=actual_size, actual_color=target_color)
        num_to_sample = int(len(distinct_objects) * sample_percentage)
        num_to_sample = max(min_other_objects, num_to_sample)
        objects_to_place = list(obligatory_objects)
        for group in self._rng.sample(distinct_objects, k=num_to_sample):
            objects_to_place.extend(group)
        for size, color, shape in objects_to_place:
            other_position = self._world.sample_position()
            self._world.place_object(Object(size=size, color=color, shape=shape),
                                     position=other_position)

    # ------------------------------------------------------------------
    # Wire-format helpers
    # ------------------------------------------------------------------

    @staticmethod
    def command_repr(command: List[str]) -> str:
        return ",".join(command)

    @staticmethod
    def parse_command_repr(command_repr: str) -> List[str]:
        return command_repr.split(",")

    @staticmethod
    def derivation_repr(derivation: Derivation) -> str:
        return str(derivation)

    def parse_derivation_repr(self, derivation_repr: str) -> Derivation:
        command_rules, command_lexicon = derivation_repr.split(";")
        return Derivation.from_str(command_rules, command_lexicon, self._grammar)

    @staticmethod
    def position_repr(position: Position) -> str:
        return ",".join([str(position.column), str(position.row)])

    @staticmethod
    def parse_position_repr(position_repr: str) -> Position:
        column, row = position_repr.split(",")
        return Position(column=int(column), row=int(row))

    # ------------------------------------------------------------------
    # Main generation driver
    # ------------------------------------------------------------------

    def get_data_pairs(self, max_examples=None, num_resampling=1,
                       other_objects_sample_percentage=0.5,
                       split_type="uniform", visualize_per_template=0,
                       visualize_per_split=0, train_percentage=0.8,
                       min_other_objects=0, k_shot_generalization=0,
                       make_dev_set=False, cut_off_target_length=25):
        """Pair every derivation with every relevant situation; assign splits."""
        if k_shot_generalization > 0 and split_type == "uniform":
            logger.info("WARNING: k_shot_generalization set to {} but for "
                        "split_type uniform this is not used.".format(
                            k_shot_generalization))

        current_situation = self._world.get_current_situation()
        current_mission = self._world.mission
        self.reset_dataset()

        situation_specifications = self.generate_situations(
            num_resampling=num_resampling)
        self.generate_all_commands()
        example_count = 0
        dropped_examples = 0
        for template_num, template_derivations in \
                self._grammar.all_derivations.items():
            visualized_per_template = 0
            visualized_per_split = {split: 0 for split in self._possible_splits}
            for derivation in template_derivations:
                arguments = []
                derivation.meaning(arguments)
                assert len(arguments) == 1, (
                    "Only one target object currently supported.")
                adverb = ""
                for word in derivation.words():
                    if word in self._vocabulary.get_adverbs():
                        adverb = word
                target_str, target_predicate = arguments.pop().to_predicate()
                possible_target_objects = self.generate_possible_targets(
                    referred_size=self._vocabulary.translate_word(
                        target_predicate["size"]),
                    referred_color=self._vocabulary.translate_word(
                        target_predicate["color"]),
                    referred_shape=self._vocabulary.translate_word(
                        target_predicate["noun"]))
                for target_size, target_color, target_shape in \
                        possible_target_objects:
                    relevant_situations = situation_specifications[
                        target_shape][target_color][target_size]
                    num_relevant_situations = len(relevant_situations)
                    idx_to_visualize = self._rng.sample(
                        range(num_relevant_situations), k=1).pop()
                    if split_type == "uniform":
                        idx_for_train = set(self._rng.sample(
                            range(num_relevant_situations),
                            k=int(num_relevant_situations * train_percentage)))
                    for i, relevant_situation in enumerate(relevant_situations):
                        visualize = False
                        if (example_count + 1) % 10000 == 0:
                            logger.info("Number of examples: {}".format(
                                example_count + 1))
                        if max_examples and example_count >= max_examples:
                            break
                        self.initialize_world_from_spec(
                            relevant_situation,
                            referred_size=target_predicate["size"],
                            referred_color=target_predicate["color"],
                            referred_shape=target_predicate["noun"],
                            actual_size=target_size,
                            sample_percentage=other_objects_sample_percentage,
                            min_other_objects=min_other_objects)
                        situation = self._world.get_current_situation()
                        assert situation.direction_to_target == \
                            relevant_situation["direction_to_target"]
                        assert situation.distance_to_target == \
                            relevant_situation["distance_to_target"]
                        target_commands, target_situations, target_action = \
                            self.demonstrate_command(
                                derivation, initial_situation=situation)
                        if i == idx_to_visualize:
                            visualize = True
                        if visualized_per_template >= visualize_per_template:
                            visualize = False
                        if adverb and visualized_per_template <= \
                                visualize_per_template:
                            visualize = True
                        if split_type == "uniform":
                            splits = ["train"] if i in idx_for_train else ["test"]
                        elif split_type == "generalization":
                            splits = self.assign_splits(
                                target_size, target_color, target_shape,
                                target_action, situation.direction_to_target,
                                target_predicate,
                                self._vocabulary.translate_word(adverb))
                            if len(splits) == 0:
                                splits = ["train"]
                            elif len(splits) > 1:
                                dropped_examples += 1
                                self._world.clear_situation()
                                continue
                            else:
                                if visualized_per_split[splits[0]] <= \
                                        visualize_per_split:
                                    visualized_per_split[splits[0]] += 1
                                    visualize = True
                        elif split_type == "target_lengths":
                            if len(target_commands) > cut_off_target_length:
                                splits = ["test"]
                            else:
                                splits = ["train"]
                        else:
                            raise ValueError(
                                "Unknown split_type in .get_data_pairs().")
                        self.fill_example(
                            command=derivation.words(), derivation=derivation,
                            situation=situation, target_commands=target_commands,
                            verb_in_command=target_action,
                            target_predicate=target_predicate,
                            visualize=visualize, adverb=adverb, splits=splits)
                        for split in splits:
                            self._template_identifiers[split].append(template_num)
                        example_count += 1
                        if visualize:
                            visualized_per_template += 1
                        self._world.clear_situation()
        logger.info("Dropped {} examples due to belonging to multiple "
                    "splits.".format(dropped_examples))
        if split_type == "generalization":
            self.make_test_set(percentage=(1 - self._percentage_train),
                               type_set="test")
        equivalent_examples = self.discard_equivalent_examples()
        logger.info("Discarded {} examples from the test set that were already "
                    "in the training set.".format(equivalent_examples))

        if make_dev_set:
            self.make_test_set(percentage=self._percentage_dev, type_set="dev")

        if k_shot_generalization > 0:
            self.move_k_examples_to_train(k_shot_generalization, split="adverb_1")

        self.initialize_world(current_situation, mission=current_mission)

    def assign_splits(self, target_size, target_color: str, target_shape: str,
                      verb_in_command: str, direction_to_target: str,
                      referred_target: dict, manner: str) -> List[str]:
        """The 7 held-out generalization conditions of the gSCAN paper."""
        splits = []
        # 1: visual — all red squares as targets.
        if target_color == "red" and target_shape == "square":
            splits.append("visual")
        # 2: situational_1 — agent south-west of target.
        if direction_to_target == "sw":
            splits.append("situational_1")
        # 3: situational_2 — circle of size 2 referred to as 'small circle'.
        if (self._vocabulary.translate_word(referred_target["size"]) == "small"
                and target_shape == "circle" and target_size == 2):
            splits.append("situational_2")
        # 4: contextual — pushing a square of size 3.
        if (self._vocabulary.translate_word(verb_in_command) == "push"
                and target_shape == "square" and target_size == 3):
            splits.append("contextual")
        # 5: adverb_1 — 'cautiously' in new situations (k-shot).
        if manner == "cautiously":
            splits.append("adverb_1")
        # 6: adverb_2 — 'while spinning' with 'pull'.
        if (verb_in_command == self._vocabulary.translate_meaning("pull")
                and manner == "while spinning"):
            splits.append("adverb_2")
        # 7: visual_easier — yellow squares referred to with 'yellow'.
        if (self._vocabulary.translate_meaning("yellow") ==
                referred_target["color"] and target_color == "yellow"
                and target_shape == "square"):
            splits.append("visual_easier")
        return splits

    def generate_all_commands(self):
        self._grammar.generate_all_commands()

    def sample_command(self) -> Tuple[Derivation, list]:
        coherent = False
        while not coherent:
            command = self._grammar.sample()
            arguments = []
            meaning = command.meaning(arguments)
            if not self._grammar.is_coherent(meaning):
                continue
            return command, arguments

    # ------------------------------------------------------------------
    # Persistence (dataset.txt wire format)
    # ------------------------------------------------------------------

    def save_dataset(self, file_name: str) -> str:
        assert len(self._data_pairs) > 0, "No data to save, call .get_data_pairs()"
        output_path = os.path.join(self.save_directory, file_name)
        with open(output_path, "w") as outfile:
            dataset_representation = {
                "grid_size": self._world.grid_size,
                "type_grammar": self._type_grammar,
                "grammar": str(self._grammar),
                "min_object_size": self._object_vocabulary.smallest_size,
                "max_object_size": self._object_vocabulary.largest_size,
                "max_recursion": self.max_recursion,
                "percentage_train": self._percentage_train,
                "examples": dict(self._data_pairs.items()),
            }
            dataset_representation.update(self._vocabulary.to_representation())
            if self._type_grammar == "simple_intrans":
                dataset_representation["transitive_verbs"] = {}
            if self._type_grammar == "simple_trans":
                dataset_representation["intransitive_verbs"] = {}
            if not (self._type_grammar == "adverb"
                    or self._type_grammar == "conjunction"):
                dataset_representation["adverbs"] = {}
            json.dump(dataset_representation, outfile, indent=4)
        return output_path

    @classmethod
    def load_dataset_from_file(cls, file_path: str, save_directory: str, k=0,
                               seed: int = 1):
        with open(file_path) as infile:
            all_data = json.load(infile)
        percentage_train = all_data.get("percentage_train") or 0.8
        dataset = cls(all_data["intransitive_verbs"],
                      all_data["transitive_verbs"], all_data["adverbs"],
                      all_data["nouns"], all_data["color_adjectives"],
                      all_data["size_adjectives"], all_data["grid_size"],
                      all_data["min_object_size"], all_data["max_object_size"],
                      type_grammar=all_data["type_grammar"],
                      save_directory=save_directory,
                      percentage_train=percentage_train,
                      max_recursion=all_data["max_recursion"],
                      sample_vocabulary="load", seed=seed)
        for split, examples in all_data["examples"].items():
            if split == "adverb_1":
                k_random_indices = dataset._rng.sample(range(len(examples)),
                                                       k=k)
            else:
                k_random_indices = []
            for i, example in enumerate(examples):
                if i in k_random_indices:
                    dataset._data_pairs["train"].append(example)
                    dataset.update_data_statistics(example, "train")
                    dataset._data_pairs["dev"].append(example)
                    dataset.update_data_statistics(example, "dev")
                else:
                    dataset._data_pairs[split].append(example)
                    dataset.update_data_statistics(example, split)
        return dataset

    @classmethod
    def load_dataset_header(cls, file_path: str, save_directory: str):
        """Reconstruct a dataset WITHOUT loading any examples.

        The analysis tools (error_analysis / position_analysis /
        visualize_prediction; reference GroundedScan/__main__.py:179-221) only
        need the dataset's vocabulary, grammar, and world machinery — all of
        which derive from dataset.txt's header fields, not from the examples.
        ``load_dataset_from_file`` json-loads the whole multi-GB file (the
        reference's approach, dataset.py:640-656), which costs tens of GB of
        RAM and minutes per analyzed file at campaign scale; this streams past
        the ``"examples"`` block (one key per line, 4-space indents — the
        save_dataset wire format, pinned by parity tests) and parses only the
        surrounding metadata.
        """
        header_lines = ["{"]
        with open(file_path, "r", buffering=1 << 20) as infile:
            first = infile.readline()
            if first.strip() != "{":
                raise ValueError("not a pretty-printed dataset.txt: "
                                 "{}".format(file_path))
            in_examples = False
            for line in infile:
                if in_examples:
                    if line.rstrip("\n") in ("    },", "    }"):
                        in_examples = False
                    continue
                if line.startswith('    "examples": {'):
                    # A one-line empty block ('"examples": {}' or '{},') is
                    # self-closing — entering skip mode on it would swallow
                    # every following header key until the next '    },'.
                    in_examples = line.rstrip("\n").rstrip(",") != \
                        '    "examples": {}'
                    continue
                header_lines.append(line)
        all_data = json.loads("".join(header_lines))
        percentage_train = all_data.get("percentage_train") or 0.8
        return cls(all_data["intransitive_verbs"],
                   all_data["transitive_verbs"], all_data["adverbs"],
                   all_data["nouns"], all_data["color_adjectives"],
                   all_data["size_adjectives"], all_data["grid_size"],
                   all_data["min_object_size"], all_data["max_object_size"],
                   type_grammar=all_data["type_grammar"],
                   save_directory=save_directory,
                   percentage_train=percentage_train,
                   max_recursion=all_data["max_recursion"],
                   sample_vocabulary="load")

    # ------------------------------------------------------------------
    # Statistics
    # ------------------------------------------------------------------

    def get_empty_data_statistics(self):
        empty_dict = {
            "distance_to_target": Counter(),
            "direction_to_target": Counter(),
            "input_length": Counter(),
            "target_length": Counter(),
            "target_shape": Counter(),
            "target_color": Counter(),
            "target_size": Counter(),
            "target_position": Counter(),
            "agent_position": Counter(),
            "verbs_in_command": defaultdict(int),
            "manners_in_command": defaultdict(int),
            "verb_adverb_combinations": defaultdict(lambda: defaultdict(int)),
            "verb_target_combinations": defaultdict(lambda: defaultdict(int)),
            "referred_targets": defaultdict(lambda: defaultdict(int)),
            "placed_targets": defaultdict(int),
            "situations": {
                key: {"objects_in_world": defaultdict(int),
                      "num_objects_placed": Counter()}
                for key in ("shape", "color,shape", "size,shape",
                            "size,color,shape", "all")},
            "examples_in_train": 0,
        }
        for target_object in self._object_vocabulary.all_objects:
            target_object_str = " ".join([str(target_object[0]),
                                          target_object[1], target_object[2]])
            for key in empty_dict["situations"].keys():
                empty_dict["situations"][key][target_object_str] = 0
            empty_dict["placed_targets"][target_object_str] = 0
        return empty_dict

    def update_data_statistics(self, data_example, split="train"):
        stats = self._data_statistics[split]
        situation = data_example["situation"]
        stats["distance_to_target"][int(situation["distance_to_target"])] += 1
        stats["direction_to_target"][situation["direction_to_target"]] += 1
        target_size = situation["target_object"]["object"]["size"]
        target_color = situation["target_object"]["object"]["color"]
        target_shape = situation["target_object"]["object"]["shape"]
        stats["target_shape"][target_shape] += 1
        stats["target_color"][target_color] += 1
        stats["target_size"][target_size] += 1
        stats["target_position"][
            (situation["target_object"]["position"]["column"],
             situation["target_object"]["position"]["row"])] += 1
        stats["agent_position"][(situation["agent_position"]["column"],
                                 situation["agent_position"]["row"])] += 1
        placed_target = " ".join([str(target_size), target_color, target_shape])
        stats["placed_targets"][placed_target] += 1

        stats["verbs_in_command"][data_example["verb_in_command"]] += 1
        manner = data_example.get("manner")
        stats["manners_in_command"][manner] += 1
        stats["referred_targets"][
            data_example.get("referred_target")][placed_target] += 1
        stats["verb_adverb_combinations"][manner][
            data_example["verb_in_command"]] += 1
        stats["verb_target_combinations"][
            data_example["verb_in_command"]][placed_target] += 1
        stats["input_length"][len(data_example["command"].split(","))] += 1
        stats["target_length"][len(data_example["target_commands"].split(","))] += 1

        referred_target = data_example.get("referred_target")
        referred_target = referred_target.split() if referred_target else [""]
        if len(referred_target) == 3:
            referred_categories = "size,color,shape"
        elif len(referred_target) == 1:
            referred_categories = "shape"
        elif referred_target[0] in self._object_vocabulary.object_colors:
            referred_categories = "color,shape"
        else:
            referred_categories = "size,shape"
        num_placed_objects = len(situation["placed_objects"].keys())
        stats["situations"][referred_categories]["num_objects_placed"][
            num_placed_objects] += 1
        stats["situations"]["all"]["num_objects_placed"][num_placed_objects] += 1
        for placed_object in situation["placed_objects"].values():
            placed_str = " ".join([placed_object["object"]["size"],
                                   placed_object["object"]["color"],
                                   placed_object["object"]["shape"]])
            stats["situations"][referred_categories]["objects_in_world"][
                placed_str] += 1
            stats["situations"]["all"]["objects_in_world"][placed_str] += 1

    def save_position_counts(self, position_counts, file):
        file.write("Columns\n")
        for row in range(self._world.grid_size):
            row_print = "Row {}".format(row)
            file.write(row_print)
            file.write((8 - len(row_print)) * " ")
            for column in range(self._world.grid_size):
                count = position_counts.get((str(column), str(row)), 0)
                count_print = "({}, {}): {}".format(column, row, count)
                file.write(count_print + (20 - len(count_print)) * " ")
            file.write("\n\n")

    def save_dataset_statistics(self, split="train"):
        """Summarize, save and plot per-split statistics."""
        for example in self._data_pairs[split]:
            self.update_data_statistics(example, split)
        stats = self._data_statistics[split]
        with open(os.path.join(self.save_directory,
                               split + "_dataset_stats.txt"), "w") as infile:
            number_of_examples = len(self._data_pairs[split])
            if number_of_examples == 0:
                logger.info("WARNING: trying to save dataset statistics for an "
                            "empty split {}.".format(split))
                return
            infile.write("Number of examples: {}\n".format(number_of_examples))
            infile.write("Number of examples of this split in train: {}\n".format(
                self._k_shot_examples_in_train[split]))
            mean_distance = sum(count * distance for distance, count in
                                stats["distance_to_target"].items())
            mean_distance /= sum(stats["distance_to_target"].values())
            infile.write("Mean walking distance to target: {}\n".format(
                mean_distance))
            infile.write("Agent positions:\n")
            self.save_position_counts(stats["agent_position"], infile)
            infile.write("Target positions:\n")
            self.save_position_counts(stats["target_position"], infile)

            def save_counter(description, counter, file):
                file.write(description + ": \n")
                for key, occurrence_count in counter.items():
                    file.write("   {}: {}\n".format(key, occurrence_count))

            infile.write("Verbs:\n")
            infile.write("Verb target combinations:\n")
            for key, values in stats["verb_target_combinations"].items():
                save_counter(" " + key, values, infile)
            infile.write("\n")
            infile.write("Adverbs:\n")
            infile.write("Adverb occurrences:\n")
            save_counter("Adverbs", stats["manners_in_command"], infile)
            infile.write("\n")
            infile.write("Verb adverb combinations:\n")
            for key, values in stats["verb_adverb_combinations"].items():
                save_counter(" " + key, values, infile)
            infile.write("\n\nReferred Targets: \n")
            for key, values in stats["referred_targets"].items():
                save_counter("  " + key, values, infile)
            infile.write("\n")
            save_counter("placed_targets", stats["placed_targets"], infile)
            infile.write("\nObjects placed in the world for particular "
                         "referenced objects: \n")
            for key, values in stats["situations"].items():
                save_counter("  " + key, values["num_objects_placed"], infile)
                save_counter("  " + key, values["objects_in_world"], infile)

        from multimodal_seq2seq_gscan_tpu_torch.analysis.plots import bar_plot
        for key, values in stats["situations"].items():
            if len(values["objects_in_world"]):
                bar_plot(values["objects_in_world"], key,
                         os.path.join(self.save_directory,
                                      split + "_" + key + ".svg"))
        for key in self.get_empty_situation().keys():
            if key not in ("agent_position", "target_position",
                           "distance_to_target"):
                bar_plot(stats[key], key,
                         os.path.join(self.save_directory,
                                      split + "_" + key + ".svg"))
        bar_plot(stats["verbs_in_command"], "verbs_in_command",
                 os.path.join(self.save_directory,
                              split + "_verbs_in_command.svg"))
        bar_plot(stats["manners_in_command"], "manners_in_command",
                 os.path.join(self.save_directory,
                              split + "_manners_in_command.svg"))
        bar_plot(stats["target_length"], "target_lengths",
                 os.path.join(self.save_directory,
                              split + "_target_lengths.svg"))
        bar_plot(stats["input_length"], "input_lengths",
                 os.path.join(self.save_directory,
                              split + "_input_lengths.svg"))

    # ------------------------------------------------------------------
    # Analysis / visualization delegates (implemented in analysis/)
    # ------------------------------------------------------------------

    def visualize_attention(self, input_commands: List[str],
                            target_commands: List[str], situation: Situation,
                            attention_weights_commands: List[List[int]],
                            attention_weights_situation: List[List[int]]):
        # Not implemented in the reference either (dataset.py:653-655); the
        # attention-GIF path is visualize_prediction.
        raise NotImplementedError()

    def error_analysis(self, predictions_file: str, output_file: str,
                       save_directory: str):
        from multimodal_seq2seq_gscan_tpu_torch.analysis.error_analysis import \
            error_analysis
        return error_analysis(self, predictions_file, output_file,
                              save_directory)

    def position_analysis(self, predictions_file: str, workbook=None):
        from multimodal_seq2seq_gscan_tpu_torch.analysis.position_analysis import \
            position_analysis
        return position_analysis(self, predictions_file, workbook=workbook)

    def visualize_prediction(self, predictions_file: str,
                             only_save_errors: bool = False,
                             max_visualized: int = None):
        from multimodal_seq2seq_gscan_tpu_torch.analysis.visualize import \
            visualize_prediction
        return visualize_prediction(self, predictions_file,
                                    only_save_errors=only_save_errors,
                                    max_visualized=max_visualized)

    def visualize_data_example(self, data_example: dict) -> str:
        from multimodal_seq2seq_gscan_tpu_torch.analysis.visualize import \
            visualize_command
        command, meaning, derivation, situation, actual_target_commands, \
            target_demonstration, _ = self.parse_example(data_example)
        mission = " ".join(["Command:", " ".join(command), "\nMeaning: ",
                            " ".join(meaning), "\nTarget:"]
                           + actual_target_commands)
        return visualize_command(self, situation, command,
                                 target_demonstration, mission=mission)

    def visualize_data_examples(self) -> List[str]:
        if len(self._examples_to_visualize) == 0:
            logger.info("No examples to visualize.")
        return [self.visualize_data_example(example)
                for example in self._examples_to_visualize]
