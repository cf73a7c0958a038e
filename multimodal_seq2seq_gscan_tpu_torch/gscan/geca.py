"""GECA-style compositional data augmentation for gSCAN datasets.

The reference runs its GECA experiment on an externally-produced augmented
dataset (reference all_experiments.sh:19-21, data/GECA — not shipped). This
module makes that experiment runnable without external data: it implements
the Good-Enough Compositional Augmentation recipe (Andreas 2020, arXiv
1904.09545) over gSCAN training commands —

1.  every command is decomposed into (environment, fragment) pairs, where an
    environment is the command with one contiguous token span gapped out;
2.  two fragments are interchangeable when they occur in at least one common
    environment;
3.  new examples re-fill an example's environment with an interchangeable
    fragment, pairing a known situation with a command it never occurred
    with.

Where classic GECA stops at "good enough" (synthesized outputs may be
wrong), gSCAN has an exact oracle: each proposed (command, situation) pair
is re-demonstrated through the world simulator, so every augmented example
carries a *correct* action sequence, and proposals whose referent is absent
or ambiguous in the donor situation are dropped. Only commands the grammar
itself generates are kept, so derivation strings stay well-formed.
"""

import itertools
import json
import logging
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Set, Tuple

from multimodal_seq2seq_gscan_tpu_torch.gscan.types import Situation

logger = logging.getLogger(__name__)

_GAP = "<GAP>"


def _situation_key(representation: dict) -> str:
    """Canonical string for a serialized Situation (key-order independent, so
    representations parsed from dataset.txt and freshly built ones compare
    equal)."""
    return json.dumps(representation, sort_keys=True)


def decompose(tokens: Tuple[str, ...], max_fragment_len: int = 3
              ) -> Iterator[Tuple[Tuple[str, ...], Tuple[str, ...]]]:
    """All (environment, fragment) splits of a token sequence with one
    contiguous gap of 1..max_fragment_len tokens (never the whole sequence)."""
    n = len(tokens)
    for start in range(n):
        for stop in range(start + 1, min(start + max_fragment_len, n) + 1):
            if stop - start == n:
                continue
            fragment = tuple(tokens[start:stop])
            environment = tuple(tokens[:start]) + (_GAP,) + tuple(tokens[stop:])
            yield environment, fragment


def interchangeable_fragments(commands: List[Tuple[str, ...]],
                              max_fragment_len: int = 3
                              ) -> Dict[Tuple[str, ...], Set[Tuple[str, ...]]]:
    """fragment -> set of interchangeable fragments (sharing an environment)."""
    by_environment: Dict[tuple, Set[tuple]] = defaultdict(set)
    for command in set(commands):
        for environment, fragment in decompose(command, max_fragment_len):
            by_environment[environment].add(fragment)
    swaps: Dict[tuple, Set[tuple]] = defaultdict(set)
    for fragments in by_environment.values():
        if len(fragments) < 2:
            continue
        for a, b in itertools.permutations(fragments, 2):
            swaps[a].add(b)
    return swaps


class GecaAugmenter:
    """Proposes and oracle-verifies recombined gSCAN training examples."""

    def __init__(self, dataset, max_fragment_len: int = 3):
        self.dataset = dataset
        # Generalization-split datasets keep train free of the 7 held-out
        # conditions (reference dataset_test.py:696-754 asserts this train
        # hygiene); augmented examples must respect the same invariant, or
        # "held-out" test numbers silently measure leaked training data.
        holdout = [s for s in dataset._possible_splits
                   if s not in ("train", "dev", "test")]
        self._filter_heldout = any(dataset._data_pairs.get(s)
                                   for s in holdout)
        grammar = dataset._grammar
        if not grammar.all_derivations:
            grammar.generate_all_commands()
        # Surface command -> Derivation, for every grammatical command.
        self.command_to_derivation = {}
        for derivations in grammar.all_derivations.values():
            for derivation in derivations:
                if not grammar.is_coherent(derivation.meaning([])):
                    continue
                self.command_to_derivation[derivation.words()] = derivation
        self.max_fragment_len = max_fragment_len

    def _train_commands(self) -> List[Tuple[str, ...]]:
        return [tuple(example["command"].split(","))
                for example in self.dataset._data_pairs["train"]]

    def _resolve_target(self, derivation, situation: Situation
                        ) -> Optional[Tuple[Situation, dict, str, str]]:
        """Locate the new command's referent in the situation.

        Returns (situation-with-target, target_predicate, verb, adverb), or
        None when the referent is absent or ambiguous (the proposal is then
        dropped — GECA never fabricates world state).
        """
        dataset = self.dataset
        # meaning() is memoized per derivation and only fills the arguments
        # list on its FIRST call (which generation already consumed), so the
        # referent is extracted from the logical form's patient term instead.
        logical_form = derivation.meaning([])
        patients = [t.arguments[1] for t in logical_form.terms
                    if t.function == "patient"]
        if len(patients) != 1:
            return None
        argument_lf = logical_form.select([patients[0]])
        target_str, target_predicate = argument_lf.to_predicate()
        translate = dataset._vocabulary.translate_word
        object_str = " ".join(translate(w) for w in target_str.split())
        object_size = translate(target_predicate["size"]) or None

        # Probe the world with target_object cleared so lookup resolves from
        # the placed objects rather than the donor command's referent.
        probe = Situation(
            grid_size=situation.grid_size, agent_position=situation.agent_pos,
            agent_direction=situation.agent_direction, target_object=None,
            placed_objects=situation.placed_objects,
            carrying=situation.carrying)
        dataset.initialize_world(probe)
        world = dataset._world
        try:
            if not world.has_object(object_str):
                return None
            locations = world.object_positions(object_str,
                                               object_size=object_size)
        except (AssertionError, ValueError):
            return None
        if len(locations) != 1:
            return None
        goal = locations[0]
        target = next((p for p in situation.placed_objects
                       if p.position == goal), None)
        if target is None:
            return None
        resolved = Situation(
            grid_size=situation.grid_size, agent_position=situation.agent_pos,
            agent_direction=situation.agent_direction, target_object=target,
            placed_objects=situation.placed_objects,
            carrying=situation.carrying)

        verbs = set(dataset._vocabulary.get_intransitive_verbs()) | set(
            dataset._vocabulary.get_transitive_verbs())
        verb = adverb = ""
        for word in derivation.words():
            if word in verbs:
                verb = word
            if word in dataset._vocabulary.get_adverbs():
                adverb = word
        return resolved, target_predicate, verb, adverb

    def augment(self, max_new: int, rng) -> int:
        """Append up to ``max_new`` oracle-verified recombinations to train.

        Returns the number of examples added."""
        dataset = self.dataset
        train = dataset._data_pairs["train"]
        commands = self._train_commands()
        swaps = interchangeable_fragments(commands, self.max_fragment_len)
        # Keyed on the RESOLVED situation each stored example carries (whose
        # target_object is the command's own referent), so a proposal that
        # exactly reproduces an existing or previously-added train example is
        # filtered out.
        seen = {(example["command"], _situation_key(example["situation"]))
                for example in train}

        order = list(range(len(train)))
        rng.shuffle(order)
        added = 0
        for example_idx in order:
            if added >= max_new:
                break
            example = train[example_idx]
            command = tuple(example["command"].split(","))
            situation = Situation.from_representation(example["situation"])
            for environment, fragment in decompose(command,
                                                   self.max_fragment_len):
                if added >= max_new:
                    break
                gap = environment.index(_GAP)
                for replacement in sorted(swaps.get(fragment, ())):
                    candidate = (environment[:gap] + replacement
                                 + environment[gap + 1:])
                    if candidate == command:
                        continue
                    derivation = self.command_to_derivation.get(candidate)
                    if derivation is None:
                        continue
                    resolved = self._resolve_target(derivation, situation)
                    if resolved is None:
                        continue
                    new_situation, predicate, verb, adverb = resolved
                    key = (",".join(candidate),
                           _situation_key(new_situation.to_representation()))
                    if key in seen:
                        continue
                    try:
                        target_commands, _, target_action = \
                            dataset.demonstrate_command(
                                derivation, initial_situation=new_situation)
                    except (AssertionError, ValueError, KeyError):
                        continue
                    if self._filter_heldout:
                        tgt = new_situation.target_object.object
                        if dataset.assign_splits(
                                tgt.size, tgt.color, tgt.shape, target_action,
                                new_situation.direction_to_target, predicate,
                                dataset._vocabulary.translate_word(adverb)):
                            continue  # would land in a held-out condition
                    dataset.fill_example(
                        command=list(candidate), derivation=derivation,
                        situation=new_situation,
                        target_commands=target_commands,
                        verb_in_command=verb, target_predicate=predicate,
                        visualize=False, adverb=adverb, splits=["train"])
                    dataset._template_identifiers["train"].append(-1)
                    seen.add(key)
                    added += 1
                    if added >= max_new:
                        break
        logger.info("GECA: added %d recombined examples to train.", added)
        return added
