"""The benchmark's own reading of a gSCAN ``dataset.txt``: one split as
numpy columns, the inputs that the program and the reference both take.

Frozen copies of the port's input rules (multimodal_seq2seq_gscan_tpu_torch
at commit cacbdcd): the vocabulary file's ``word_to_idx`` with SOS/EOS
around each sentence and out-of-vocabulary words mapped to the pad id
(``core/vocabulary.py``), the dense situation grid
(``gscan/encode.py::encode_situation_from_representation``) and the
zero-padded id matrices (``data/dataset.py``: ``_ensure_packed`` pads to the
split's longest sequence, a batch to its longest rounded up to 8).
"""

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np

PAD, SOS, EOS = 0, 1, 2
LENGTH_BUCKET = 8


class Split(NamedTuple):
    """One split, the columns of the port's ``ResidentData`` in its order."""

    input_ids: np.ndarray         # [N, T_in] int32
    input_lengths: np.ndarray     # [N] int32
    situations: np.ndarray        # [N, G, G, C] uint8
    target_ids: np.ndarray        # [N, T_out] int32
    target_lengths: np.ndarray    # [N] int32
    agent_positions: np.ndarray   # [N] int32
    target_positions: np.ndarray  # [N] int32

    @property
    def num_examples(self) -> int:
        return self.input_ids.shape[0]


def _vocabulary(path: Path) -> dict:
    with open(path) as f:
        return {word: int(i)
                for word, i in json.load(f)["word_to_idx"].items()}


def _ids(sentence: str, vocabulary: dict) -> list:
    return ([SOS] + [vocabulary.get(w, PAD) for w in sentence.split(",")]
            + [EOS])


def encode_situation(situation: dict, grid_size: int) -> np.ndarray:
    """Dense [grid, grid, attributes + 5] uint8 grid: each object's
    attribute vector, then the agent bit and the one-hot agent direction."""
    target = situation["target_object"]
    if target is not None:
        attributes = len(target["vector"])
    else:
        attributes = len(next(iter(
            situation["placed_objects"].values()))["vector"])
    grid = np.zeros((grid_size, grid_size, attributes + 5), np.uint8)
    for placed in situation["placed_objects"].values():
        vector = np.frombuffer(placed["vector"].encode(), np.uint8) - ord("0")
        grid[int(placed["position"]["row"]),
             int(placed["position"]["column"]), :attributes] = vector
    row = int(situation["agent_position"]["row"])
    column = int(situation["agent_position"]["column"])
    grid[row, column, attributes] = 1
    grid[row, column, attributes + 1 + int(situation["agent_direction"])] = 1
    return grid


def _padded(rows: list, width: int) -> np.ndarray:
    out = np.zeros((len(rows), width), np.int32)
    for i, row in enumerate(rows):
        out[i, :len(row)] = row
    return out


def bucketed(length: int) -> int:
    """A batch's padded width: its longest sequence rounded up to 8."""
    return -(-max(int(length), 2) // LENGTH_BUCKET) * LENGTH_BUCKET


def load_split(root: Path, data: dict, split: str,
               bucket_inputs: bool) -> Split:
    """The split's columns. ``data`` is a configuration's ``data`` entry
    (paths relative to ``root``). Target ids are padded to the split's
    longest target; input ids to its longest command, or, with
    ``bucket_inputs``, to that rounded up to 8 (a batch that holds the
    split's longest command)."""
    with open(root / data["dataset"]) as f:
        parsed = json.load(f)
    grid_size = int(parsed["grid_size"])
    examples = parsed["examples"][split]
    commands = _vocabulary(root / data["input_vocabulary"])
    targets = _vocabulary(root / data["target_vocabulary"])
    inputs = [_ids(e["command"], commands) for e in examples]
    outputs = [_ids(e["target_commands"], targets) for e in examples]
    input_width = max(len(r) for r in inputs)
    if bucket_inputs:
        input_width = bucketed(input_width)

    def flat(position):
        return int(position["row"]) * grid_size + int(position["column"])

    return Split(
        input_ids=_padded(inputs, input_width),
        input_lengths=np.array([len(r) for r in inputs], np.int32),
        situations=np.stack([encode_situation(e["situation"], grid_size)
                             for e in examples]),
        target_ids=_padded(outputs, max(len(r) for r in outputs)),
        target_lengths=np.array([len(r) for r in outputs], np.int32),
        agent_positions=np.array(
            [flat(e["situation"]["agent_position"]) for e in examples],
            np.int32),
        target_positions=np.array(
            [flat(e["situation"]["target_object"]["position"])
             for e in examples], np.int32))


def vocabulary_sizes(root: Path, data: dict):
    """(input, target) vocabulary sizes of a configuration's ``data``."""
    sizes = []
    for key in ("input_vocabulary", "target_vocabulary"):
        with open(root / data[key]) as f:
            sizes.append(len(json.load(f)["idx_to_word"]))
    return tuple(sizes)
