"""Vectorized sparse -> dense situation encoding.

Produces the exact tensor ``World.get_current_situation_grid_repr`` (and the
reference's ``Grid.encode``, minigrid.py:380-399) yields, but straight from the
serialized situation dict — no world re-simulation. This removes the reference's
~57-minute dataset load (re-simulating 368k examples through minigrid;
cf. reference seq2seq/gSCAN_dataset.py:242 -> GroundedScan/dataset.py:152-158).

Per-cell channel layout (documented in reference read_gscan/read_gscan.py:22-55):
``[object vector (one-hot size ++ one-hot color/shape) | agent bit | one-hot dir]``.
"""

from typing import Dict

import numpy as np


def num_grid_channels(num_object_attributes: int) -> int:
    return num_object_attributes + 1 + 4


def encode_situation_from_representation(situation_representation: Dict,
                                         grid_size: int) -> np.ndarray:
    """Dense [grid, grid, D+5] uint8 grid from a serialized situation dict.

    Unlike read_gscan's ``parse_sparse_situation`` (which zeroes the agent cell's
    object bits), this matches ``Grid.encode``: an object sharing the agent's cell
    keeps its attribute vector, with the agent bits set on top.
    """
    target_object = situation_representation["target_object"]
    if target_object is not None:
        num_object_attributes = len(target_object["vector"])
    else:
        placed = next(iter(situation_representation["placed_objects"].values()))
        num_object_attributes = len(placed["vector"])
    channels = num_grid_channels(num_object_attributes)

    grid = np.zeros((grid_size, grid_size, channels), dtype="uint8")
    for placed_object in situation_representation["placed_objects"].values():
        row = int(placed_object["position"]["row"])
        column = int(placed_object["position"]["column"])
        vector = np.frombuffer(placed_object["vector"].encode(), dtype=np.uint8) - ord("0")
        grid[row, column, :num_object_attributes] = vector

    agent_row = int(situation_representation["agent_position"]["row"])
    agent_column = int(situation_representation["agent_position"]["column"])
    agent_direction = int(situation_representation["agent_direction"])
    grid[agent_row, agent_column, num_object_attributes] = 1
    grid[agent_row, agent_column, num_object_attributes + 1 + agent_direction] = 1
    return grid
