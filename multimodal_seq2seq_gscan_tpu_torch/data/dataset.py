"""dataset.txt -> padded, bucketed torch batches (one split).

The port's counterpart of the JAX package's ``data/dataset.py``: the same
tokenization, the same uint8 dense situation grids (``gscan/encode.py``), the
same bucketed padding (sequence dims rounded up to a multiple of 8) and the
same optional zero-row padding of a short final batch, and the same
(length-bucketed) shuffle, so both packages build identical batches from one
file and one numpy seed. It carries no dataset engine. The file is parsed
once, and several splits share the parse through ``dataset=``, by one of
the JAX loader's backends (``backend``):

- ``"native"``: the port's C++ mmap scanner (``data/native_loader.py``,
  built at first use), which rasterizes the grids as it scans and leaves
  the strings in the mapped file; it raises if the library cannot be
  built;
- ``"engine"``: ``json.load`` of the whole file (``ParsedDataset``);
- ``"auto"`` (the default): native when the library builds, else engine,
  with a logged warning.

Both give the same arrays, vocabularies, k-shot move and strings. The
k-shot move (``k > 0``) is the JAX loader's native backend's: ``k``
examples of ``adverb_1``, drawn by ``random.Random(k_shot_seed).sample``,
are appended to train and dev and removed from ``adverb_1`` at parse time.
With ``generate_vocabulary`` both vocabularies are built from the split's
commands and targets (``save_vocabularies`` writes them).

Each example's situation dict and derivation string are kept for
``predict.json`` (the JAX dataset's ``situation_representation`` and
``derivation_representation``; decoded from the mapped file on access
under the native backend), and the split is also held as packed columns
(``_ensure_packed``: ``[N, T_in]`` and ``[N, T_out]`` id matrices, the
uint8 situation stack, the length and position vectors), which batch
assembly slices and the resident trainer puts on the device whole.
"""

import json
import logging
import os
import random
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from multimodal_seq2seq_gscan_tpu_torch.core.batch import Batch
from multimodal_seq2seq_gscan_tpu_torch.core.vocabulary import Vocabulary
from multimodal_seq2seq_gscan_tpu_torch.data import native_loader
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


class _JsonSplit:
    """A split of a ``ParsedDataset`` behind ``NativeSplit``'s accessors."""

    def __init__(self, examples: list):
        self.examples = examples

    def __len__(self) -> int:
        return len(self.examples)

    def command(self, i: int) -> str:
        return self.examples[i]["command"]

    def target_commands(self, i: int) -> str:
        return self.examples[i]["target_commands"]

    def derivation(self, i: int) -> Optional[str]:
        return self.examples[i].get("derivation")

    def situation(self, i: int) -> dict:
        return self.examples[i]["situation"]


class _LazyList:
    """A list-like view that calls ``get(i)`` on access (the native
    backend's situation dicts and derivation strings)."""

    def __init__(self, get, n: int):
        self._get, self._n = get, n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int):
        return self._get(i)


BACKENDS = ("auto", "native", "engine")
Parse = Union[ParsedDataset, native_loader.NativeDataset]


def parse_dataset(path_to_data: str, backend: str = "auto", k: int = 0,
                  k_shot_seed: Optional[int] = None) -> Tuple[Parse, str]:
    """(the parse of every split of the file, the backend that made it),
    the k-shot move applied (module docstring)."""
    if backend not in BACKENDS:
        raise ValueError("backend must be one of {}, got {!r}".format(
            BACKENDS, backend))
    if backend == "auto":
        try:
            native_loader.library()
            backend = "native"
        except RuntimeError as error:
            logger.warning("The native loader cannot be built, so the "
                           "dataset is parsed with json (backend 'engine'):"
                           " %s", error)
            backend = "engine"
    if backend == "engine":
        return ParsedDataset(path_to_data, k=k,
                             k_shot_seed=k_shot_seed), backend
    logger.info("Loading dataset via the native scanner...")
    dataset = native_loader.NativeDataset(path_to_data)
    # Seeded so that the move repeats run to run (the reference draws from
    # the globally seeded ``random`` module).
    dataset.move_k_examples_to_train_and_dev(
        k, random.Random(k_shot_seed) if k_shot_seed is not None
        else random)
    return dataset, backend


class GroundedScanDataset:
    """One split of a gSCAN dataset.txt, served as padded, bucketed batches.

    ``dataset`` takes an earlier split's parse (``.dataset``), so that the
    file is parsed once, by the backend that made it (``.backend``; a
    ``backend`` other than ``"auto"`` must be that one); ``backend``, ``k``
    and ``k_shot_seed`` otherwise apply to a parse made here."""

    def __init__(self, path_to_data: str, save_directory: str,
                 split: str = "train",
                 input_vocabulary_file: str = "training_input_vocab.txt",
                 target_vocabulary_file: str = "training_target_vocab.txt",
                 generate_vocabulary: bool = False, k: int = 0,
                 dataset: Optional[Parse] = None,
                 k_shot_seed: Optional[int] = None, backend: str = "auto"):
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
        if dataset is None:
            dataset, backend = parse_dataset(path_to_data, backend, k,
                                             k_shot_seed)
        else:
            shared = ("native" if isinstance(
                dataset, native_loader.NativeDataset) else "engine")
            if backend not in ("auto", shared):
                raise ValueError("dataset= is a parse of backend {!r}, not "
                                 "{!r}".format(shared, backend))
            backend = shared
        self.dataset, self.backend = dataset, backend
        if generate_vocabulary:
            self.input_vocabulary = Vocabulary()
            self.target_vocabulary = Vocabulary()
            examples = self._examples()
            for i in range(len(examples)):
                self.input_vocabulary.add_sentence(
                    examples.command(i).split(","))
                self.target_vocabulary.add_sentence(
                    examples.target_commands(i).split(","))
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

    def _examples(self):
        """The split behind ``NativeSplit``'s accessors."""
        examples = self.dataset.splits.get(self.split)
        if examples is None:
            raise KeyError("Split {} not present in {}".format(
                self.split, self.path_to_data))
        return (examples if isinstance(examples, native_loader.NativeSplit)
                else _JsonSplit(examples))

    def save_vocabularies(self, input_vocabulary_file: str,
                          target_vocabulary_file: str):
        """Write both vocabularies into the save directory, in the JSON the
        JAX package's ``Vocabulary.load`` reads."""
        self.input_vocabulary.save(
            os.path.join(self.directory, input_vocabulary_file))
        self.target_vocabulary.save(
            os.path.join(self.directory, target_vocabulary_file))

    def read_dataset(self, max_examples: Optional[int] = None):
        """Tokenize and encode the split's examples once into numpy
        columns (the first ``max_examples`` of them, if given)."""
        grid_size = self.dataset.grid_size
        examples = self._examples()
        n = min(len(examples), max_examples or len(examples))
        self.input_ids = [np.asarray(self.input_vocabulary.sentence_to_array(
            examples.command(i).split(",")), dtype=np.int32)
            for i in range(n)]
        self.target_ids = [np.asarray(
            self.target_vocabulary.sentence_to_array(
                examples.target_commands(i).split(",")), dtype=np.int32)
            for i in range(n)]
        if isinstance(examples, native_loader.NativeSplit):
            self._situations = examples.grids[:n]
            self._agent_positions = examples.positions[:n, 0].copy()
            self._target_positions = examples.positions[:n, 1].copy()
            self._situation_representations = _LazyList(
                examples.situation, n)
            self._derivation_representations = _LazyList(
                examples.derivation, n)
        else:
            reps = [examples.situation(i) for i in range(n)]
            self._situations = np.stack([
                encode_situation_from_representation(rep, grid_size)
                for rep in reps])
            self._agent_positions = np.asarray(
                [_flat_position(rep["agent_position"], grid_size)
                 for rep in reps], np.int32)
            self._target_positions = np.asarray(
                [_flat_position(rep["target_object"]["position"], grid_size)
                 for rep in reps], np.int32)
            self._situation_representations = reps
            self._derivation_representations = [
                examples.derivation(i) for i in range(n)]
        self.image_channels = int(self._situations.shape[-1])
        self._input_lengths = np.array([len(a) for a in self.input_ids],
                                       np.int32)
        self._target_lengths = np.array([len(a) for a in self.target_ids],
                                        np.int32)
        self._order = np.arange(n, dtype=np.int64)
        self._packed = False
        logger.info("Read %d %s examples (%s backend).", n, self.split,
                    self.backend)

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
