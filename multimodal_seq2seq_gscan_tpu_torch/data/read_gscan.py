"""Standalone, dependency-free gSCAN dataset loader.

Mirrors the reference's ``read_gscan/read_gscan.py`` sidecar: documents the
canonical dense per-cell encoding and loads a ``dataset.txt`` without any
dependency on the dataset engine.

Per-cell feature vector layout:
``[size 1..4 one-hot | color one-hot | shape one-hot | agent bit | E S W N]``
(the exact order of color/shape entries follows the vocabulary order used at
generation time; see gscan/object_vocabulary.py).

NOTE: like ``Grid.encode`` (and unlike the reference sidecar, which zeroes the
object bits under the agent), an object sharing the agent's cell keeps its
attribute vector.
"""

import json
import logging
from typing import Dict, List

import numpy as np

logger = logging.getLogger(__name__)


def parse_sparse_situation(situation_representation: dict,
                           grid_size: int) -> np.ndarray:
    """Build the dense [grid, grid, D+5] grid from a serialized situation."""
    num_object_attributes = len(
        situation_representation["target_object"]["vector"])
    num_grid_channels = num_object_attributes + 1 + 4

    grid = np.zeros([grid_size, grid_size, num_grid_channels], dtype=int)
    for placed_object in situation_representation["placed_objects"].values():
        object_vector = np.array([int(bit) for bit in placed_object["vector"]],
                                 dtype=int)
        object_row = int(placed_object["position"]["row"])
        object_column = int(placed_object["position"]["column"])
        grid[object_row, object_column, :num_object_attributes] = object_vector

    agent_row = int(situation_representation["agent_position"]["row"])
    agent_column = int(situation_representation["agent_position"]["column"])
    agent_direction = int(situation_representation["agent_direction"])
    grid[agent_row, agent_column, num_object_attributes] = 1
    grid[agent_row, agent_column,
         num_object_attributes + 1 + agent_direction] = 1
    return grid


def data_loader(file_path: str) -> Dict[str, List[dict]]:
    """Load all splits of a dataset.txt into plain dicts with dense grids."""
    with open(file_path) as infile:
        all_data = json.load(infile)
    grid_size = int(all_data["grid_size"])
    splits = list(all_data["examples"].keys())
    logger.info("Found data splits: {}".format(splits))
    loaded_data = {}
    for split in splits:
        loaded_data[split] = []
        logger.info("Now loading data for split: {}".format(split))
        for data_example in all_data["examples"][split]:
            loaded_data[split].append({
                "input": data_example["command"].split(","),
                "target": data_example["target_commands"].split(","),
                "situation": parse_sparse_situation(
                    situation_representation=data_example["situation"],
                    grid_size=grid_size).tolist(),
            })
        logger.info("Loaded {} examples in split {}.".format(
            len(loaded_data[split]), split))
    return loaded_data
