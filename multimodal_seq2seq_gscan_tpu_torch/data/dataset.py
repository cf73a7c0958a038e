"""dataset.txt -> padded, bucketed torch batches (one split, read with json).

The port's counterpart of the JAX package's ``data/dataset.py``: the same
tokenization, the same uint8 dense situation grids (``gscan/encode.py``), the
same bucketed padding (sequence dims rounded up to a multiple of 8) and the
same optional zero-row padding of a short final batch, and the same
(length-bucketed) shuffle, so both packages build identical batches from one
file and one numpy seed. It reads the splits straight from the JSON
(``ParsedDataset``: one parse of the file, which several splits share
through ``dataset=``, as the JAX loader's) and carries neither the dataset
engine nor the C++ scanner. The k-shot move (``k > 0``) follows the JAX
loader's default backend, the native scanner's: ``k`` examples of
``adverb_1``, drawn by ``random.Random(k_shot_seed).sample``, are appended
to train and dev and removed from ``adverb_1`` at parse time. With
``generate_vocabulary`` both vocabularies are built from the split's
commands and targets (``save_vocabularies`` writes them).

Each example's situation dict and derivation string are kept for
``predict.json`` (the JAX dataset's ``situation_representation`` and
``derivation_representation``), and the split is also held as packed
columns (``_ensure_packed``: ``[N, T_in]`` and ``[N, T_out]`` id matrices,
the uint8 situation stack, the length and position vectors), which batch
assembly slices and the resident trainer puts on the device whole.
"""

import json
import logging
import os
import random
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from multimodal_seq2seq_gscan_tpu_torch.core.batch import Batch
from multimodal_seq2seq_gscan_tpu_torch.core.vocabulary import Vocabulary
from multimodal_seq2seq_gscan_tpu_torch.gscan.encode import (
    encode_situation_from_representation)

logger = logging.getLogger(__name__)


def _round_up(value: int, multiple: int) -> int:
    return ((value + multiple - 1) // multiple) * multiple


# Sequence dims are padded up to a multiple of this (the JAX loader's
# default), so a split yields a handful of shapes.
LENGTH_BUCKET_SIZE = 8


def _flat_position(position: dict, grid_size: int) -> int:
    return int(position["row"]) * grid_size + int(position["column"])


class ParsedDataset:
    """One parse of a dataset.txt: its grid size and each split's example
    dicts, the k-shot move applied once."""

    def __init__(self, path_to_data: str, k: int = 0,
                 k_shot_seed: Optional[int] = None):
        with open(path_to_data) as f:
            data = json.load(f)
        self.grid_size = int(data["grid_size"])
        self.splits: Dict[str, list] = data["examples"]
        if k > 0:
            # Seeded so that the move repeats run to run (the reference
            # draws from the globally seeded ``random`` module).
            self.move_k_examples_to_train_and_dev(
                k, random.Random(k_shot_seed) if k_shot_seed is not None
                else random)

    def move_k_examples_to_train_and_dev(self, k: int, rng,
                                         split: str = "adverb_1"):
        """k random examples of ``split`` (``rng.sample``) appended to train
        and dev, and removed from ``split`` (the JAX native loader's
        ``move_k_examples_to_train_and_dev``); a no-op without ``split`` or
        a train split."""
        if k <= 0 or split not in self.splits or "train" not in self.splits:
            return
        source = self.splits[split]
        chosen = rng.sample(range(len(source)), k=min(k, len(source)))
        chosen_set = set(chosen)
        for destination in ("train", "dev"):
            if destination in self.splits:
                self.splits[destination] = (self.splits[destination]
                                            + [source[i] for i in chosen])
        self.splits[split] = [example for i, example in enumerate(source)
                              if i not in chosen_set]


class GroundedScanDataset:
    """One split of a gSCAN dataset.txt, served as padded, bucketed batches.

    ``dataset`` takes an earlier split's parse (``.dataset``), so that the
    file is parsed once; ``k`` and ``k_shot_seed`` apply only to a parse
    made here."""

    def __init__(self, path_to_data: str, save_directory: str,
                 split: str = "train",
                 input_vocabulary_file: str = "training_input_vocab.txt",
                 target_vocabulary_file: str = "training_target_vocab.txt",
                 generate_vocabulary: bool = False, k: int = 0,
                 dataset: Optional[ParsedDataset] = None,
                 k_shot_seed: Optional[int] = None):
        if not os.path.isfile(path_to_data):
            raise FileNotFoundError(
                "Trying to read a gSCAN dataset from a non-existing file "
                "{}.".format(path_to_data))
        if split == "test" and generate_vocabulary:
            logger.warning("WARNING: generating a vocabulary from the test "
                           "set.")
        self.path_to_data = path_to_data
        self.split = split
        self.directory = save_directory
        self.dataset = dataset if dataset is not None else ParsedDataset(
            path_to_data, k=k, k_shot_seed=k_shot_seed)
        if generate_vocabulary:
            self.input_vocabulary = Vocabulary()
            self.target_vocabulary = Vocabulary()
            for example in self._examples():
                self.input_vocabulary.add_sentence(
                    example["command"].split(","))
                self.target_vocabulary.add_sentence(
                    example["target_commands"].split(","))
        else:
            self.input_vocabulary = Vocabulary.load(
                os.path.join(save_directory, input_vocabulary_file))
            self.target_vocabulary = Vocabulary.load(
                os.path.join(save_directory, target_vocabulary_file))
        self.image_channels: Optional[int] = None
        self.input_ids: List[np.ndarray] = []
        self.target_ids: List[np.ndarray] = []
        self._situations = np.zeros((0,), np.uint8)
        self._input_lengths = np.zeros((0,), np.int32)
        self._target_lengths = np.zeros((0,), np.int32)
        self._agent_positions = np.zeros((0,), np.int32)
        self._target_positions = np.zeros((0,), np.int32)
        self._situation_representations: List[dict] = []
        self._derivation_representations: List[Optional[str]] = []
        self._order = np.zeros((0,), np.int64)
        self._packed = False

    def _examples(self) -> list:
        examples = self.dataset.splits.get(self.split)
        if examples is None:
            raise KeyError("Split {} not present in {}".format(
                self.split, self.path_to_data))
        return examples

    def save_vocabularies(self, input_vocabulary_file: str,
                          target_vocabulary_file: str):
        """Write both vocabularies into the save directory, in the JSON the
        JAX package's ``Vocabulary.load`` reads."""
        self.input_vocabulary.save(
            os.path.join(self.directory, input_vocabulary_file))
        self.target_vocabulary.save(
            os.path.join(self.directory, target_vocabulary_file))

    def read_dataset(self, max_examples: Optional[int] = None):
        """Tokenize and encode the split's examples once into numpy columns."""
        grid_size = self.dataset.grid_size
        examples = self._examples()
        if max_examples:
            examples = examples[:max_examples]
        situations, agent_positions, target_positions = [], [], []
        for example in examples:
            self.input_ids.append(np.asarray(
                self.input_vocabulary.sentence_to_array(
                    example["command"].split(",")), dtype=np.int32))
            self.target_ids.append(np.asarray(
                self.target_vocabulary.sentence_to_array(
                    example["target_commands"].split(",")), dtype=np.int32))
            rep = example["situation"]
            situations.append(
                encode_situation_from_representation(rep, grid_size))
            agent_positions.append(
                _flat_position(rep["agent_position"], grid_size))
            target_positions.append(
                _flat_position(rep["target_object"]["position"], grid_size))
            self._situation_representations.append(rep)
            self._derivation_representations.append(
                example.get("derivation"))
        self._situations = np.stack(situations)
        self.image_channels = int(self._situations.shape[-1])
        self._input_lengths = np.array([len(a) for a in self.input_ids],
                                       np.int32)
        self._target_lengths = np.array([len(a) for a in self.target_ids],
                                        np.int32)
        self._agent_positions = np.asarray(agent_positions, np.int32)
        self._target_positions = np.asarray(target_positions, np.int32)
        self._order = np.arange(len(self.input_ids), dtype=np.int64)
        self._packed = False
        logger.info("Read %d %s examples.", len(self.input_ids), self.split)

    def shuffle_data(self, rng: Optional[np.random.Generator] = None,
                     bucket_by_length_with_batch_size: Optional[int] = None):
        """A random order of the examples for the iterator.

        With ``bucket_by_length_with_batch_size`` the permutation is sorted
        by target length within windows of 64 batches and the batches'
        order is shuffled, so a batch's padded width tracks its own longest
        target (the JAX loader's ``shuffle_data``, draw for draw).
        """
        if rng is None:
            rng = np.random.default_rng()
        order = rng.permutation(len(self.input_ids))
        batch_size = bucket_by_length_with_batch_size
        if batch_size:
            window = batch_size * 64
            pieces = []
            for start in range(0, len(order), window):
                chunk = order[start:start + window]
                pieces.append(chunk[np.argsort(self._target_lengths[chunk],
                                               kind="stable")])
            order = np.concatenate(pieces) if pieces else order
            starts = np.arange(0, len(order), batch_size)
            rng.shuffle(starts)
            order = np.concatenate([order[s:s + batch_size] for s in starts])
        self._order = order

    def _bucketed_length(self, length: int) -> int:
        return _round_up(max(int(length), 2), LENGTH_BUCKET_SIZE)

    def _ensure_packed(self):
        """Build the packed columns once: ``_input_matrix`` [N, T_in] and
        ``_target_matrix`` [N, T_out] (int32, zero-padded to the split's
        longest sequence) and ``_situation_stack`` [N, H, W, C] uint8."""
        if self._packed:
            return
        n = len(self.input_ids)
        max_in = int(self._input_lengths.max()) if n else 0
        max_out = int(self._target_lengths.max()) if n else 0
        self._input_matrix = np.zeros((n, max_in), np.int32)
        self._target_matrix = np.zeros((n, max_out), np.int32)
        for i in range(n):
            self._input_matrix[i, :self._input_lengths[i]] = self.input_ids[i]
            self._target_matrix[i, :self._target_lengths[i]] = \
                self.target_ids[i]
        self._situation_stack = self._situations
        self._packed = True

    def get_data_iterator(self, batch_size: int = 10,
                          pad_to_full_batch: bool = False,
                          with_representations: bool = True
                          ) -> Iterator[Tuple[Batch, np.ndarray, List[dict],
                                              List[Optional[str]]]]:
        """Yield (Batch on the CPU, example indices, situation dicts,
        derivation strings) in the current order (file order until
        ``shuffle_data``), as the JAX loader does.

        Sequence dims are padded to the bucketed max length of the batch;
        with ``pad_to_full_batch`` a short final batch gets zero rows up to
        ``batch_size`` (rows beyond ``len(example_indices)``).
        ``with_representations=False`` yields empty lists for the last two
        (training does not need them).
        """
        self._ensure_packed()
        n = len(self._order)
        for start in range(0, n, batch_size):
            idx = self._order[start:start + batch_size]
            rows = batch_size if pad_to_full_batch else len(idx)
            pad_rows = rows - len(idx)

            def gather(column: np.ndarray, width: Optional[int] = None
                       ) -> torch.Tensor:
                block = column[idx] if width is None else \
                    column[idx, :width]
                if width is not None and block.shape[1] < width:
                    block = np.pad(block, ((0, 0),
                                           (0, width - block.shape[1])))
                if pad_rows:
                    block = np.concatenate(
                        [block, np.zeros((pad_rows,) + block.shape[1:],
                                         block.dtype)])
                return torch.from_numpy(np.ascontiguousarray(block))

            max_in = self._bucketed_length(self._input_lengths[idx].max())
            max_out = self._bucketed_length(self._target_lengths[idx].max())
            batch = Batch(
                input_ids=gather(self._input_matrix, max_in),
                input_lengths=gather(self._input_lengths),
                situations=gather(self._situation_stack).float(),
                target_ids=gather(self._target_matrix, max_out),
                target_lengths=gather(self._target_lengths),
                agent_positions=gather(self._agent_positions),
                target_positions=gather(self._target_positions))
            if with_representations:
                yield (batch, idx,
                       [self._situation_representations[i] for i in idx],
                       [self._derivation_representations[i] for i in idx])
            else:
                yield batch, idx, [], []

    def array_to_sentence(self, sentence_array: List[int],
                          vocabulary: str) -> List[str]:
        """Token ids to words with the ``"input"`` or ``"target"``
        vocabulary."""
        if vocabulary not in ("input", "target"):
            raise ValueError("Specified unknown vocabulary in "
                             "array_to_sentence: {}".format(vocabulary))
        return getattr(self, vocabulary + "_vocabulary").array_to_sentence(
            sentence_array)

    @property
    def num_examples(self) -> int:
        return len(self.input_ids)

    @property
    def input_vocabulary_size(self) -> int:
        return self.input_vocabulary.size

    @property
    def target_vocabulary_size(self) -> int:
        return self.target_vocabulary.size
