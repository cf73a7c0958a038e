"""dataset.txt -> padded, bucketed torch batches (one split, read with json).

The port's counterpart of the JAX package's ``data/dataset.py``: the same
tokenization, the same uint8 dense situation grids (``gscan/encode.py``), the
same bucketed padding (sequence dims rounded up to a multiple of 8) and the
same optional zero-row padding of a short final batch, so both packages
build identical batches from one file. It reads the split straight from the
JSON and carries neither the dataset engine nor the C++ scanner; the k-shot
split moves are not supported.
"""

import json
import logging
import os
from typing import Iterator, List, Optional, Tuple

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


class GroundedScanDataset:
    """One split of a gSCAN dataset.txt, served as padded, bucketed batches."""

    def __init__(self, path_to_data: str, save_directory: str,
                 split: str = "train",
                 input_vocabulary_file: str = "training_input_vocab.txt",
                 target_vocabulary_file: str = "training_target_vocab.txt"):
        if not os.path.isfile(path_to_data):
            raise FileNotFoundError(
                "Trying to read a gSCAN dataset from a non-existing file "
                "{}.".format(path_to_data))
        self.path_to_data = path_to_data
        self.split = split
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

    def read_dataset(self, max_examples: Optional[int] = None):
        """Tokenize and encode the split's examples once into numpy columns."""
        with open(self.path_to_data) as f:
            data = json.load(f)
        grid_size = int(data["grid_size"])
        examples = data["examples"].get(self.split)
        if examples is None:
            raise KeyError("Split {} not present in {}".format(
                self.split, self.path_to_data))
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
        self._situations = np.stack(situations)
        self.image_channels = int(self._situations.shape[-1])
        self._input_lengths = np.array([len(a) for a in self.input_ids],
                                       np.int32)
        self._target_lengths = np.array([len(a) for a in self.target_ids],
                                        np.int32)
        self._agent_positions = np.asarray(agent_positions, np.int32)
        self._target_positions = np.asarray(target_positions, np.int32)
        logger.info("Read %d %s examples.", len(self.input_ids), self.split)

    def _bucketed_length(self, length: int) -> int:
        return _round_up(max(int(length), 2), LENGTH_BUCKET_SIZE)

    @staticmethod
    def _padded_matrix(rows: List[np.ndarray], width: int) -> np.ndarray:
        matrix = np.zeros((len(rows), width), np.int32)
        for i, row in enumerate(rows):
            matrix[i, :len(row)] = row
        return matrix

    def get_data_iterator(self, batch_size: int = 10,
                          pad_to_full_batch: bool = False
                          ) -> Iterator[Tuple[Batch, np.ndarray]]:
        """Yield (Batch on the CPU, example indices) in file order.

        Sequence dims are padded to the bucketed max length of the batch;
        with ``pad_to_full_batch`` a short final batch gets zero rows up to
        ``batch_size`` (rows beyond ``len(example_indices)``).
        """
        n = len(self.input_ids)
        for start in range(0, n, batch_size):
            idx = np.arange(start, min(start + batch_size, n), dtype=np.int64)
            rows = batch_size if pad_to_full_batch else len(idx)
            pad_rows = rows - len(idx)

            def pad(block: np.ndarray) -> torch.Tensor:
                if pad_rows:
                    block = np.concatenate(
                        [block, np.zeros((pad_rows,) + block.shape[1:],
                                         block.dtype)])
                return torch.from_numpy(np.ascontiguousarray(block))

            max_in = self._bucketed_length(self._input_lengths[idx].max())
            max_out = self._bucketed_length(self._target_lengths[idx].max())
            yield Batch(
                input_ids=pad(self._padded_matrix(
                    [self.input_ids[i] for i in idx], max_in)),
                input_lengths=pad(self._input_lengths[idx]),
                situations=pad(self._situations[idx].astype(np.float32)),
                target_ids=pad(self._padded_matrix(
                    [self.target_ids[i] for i in idx], max_out)),
                target_lengths=pad(self._target_lengths[idx]),
                agent_positions=pad(self._agent_positions[idx]),
                target_positions=pad(self._target_positions[idx])), idx

    @property
    def num_examples(self) -> int:
        return len(self.input_ids)

    @property
    def input_vocabulary_size(self) -> int:
        return self.input_vocabulary.size

    @property
    def target_vocabulary_size(self) -> int:
        return self.target_vocabulary.size
