"""The port's world simulator (``gscan/world.py``), case for case the JAX
package's tests/test_world.py: turns, routes, manners, push/pull mechanics.
Imports nothing of JAX, so that the engine's ``--mode=test`` runs it where
JAX is not installed."""

import pytest

from multimodal_seq2seq_gscan_tpu_torch.gscan.object_vocabulary import ObjectVocabulary
from multimodal_seq2seq_gscan_tpu_torch.gscan.types import (
    EAST, INT_TO_DIR, NORTH, SOUTH, WEST, Object, Position)
from multimodal_seq2seq_gscan_tpu_torch.gscan.world import World


def _world(grid_size=6):
    vocabulary = ObjectVocabulary(shapes=["circle", "square", "cylinder"],
                                  colors=["red", "blue", "green", "yellow"],
                                  min_size=1, max_size=4)
    return World(grid_size=grid_size, shapes=["circle", "square", "cylinder"],
                 colors=["red", "blue", "green", "yellow"],
                 object_vocabulary=vocabulary)


@pytest.mark.parametrize("start,target,expected", [
    # From East (0): South -> right; North -> left; West -> two lefts.
    (0, SOUTH, ["turn right"]),
    (0, NORTH, ["turn left"]),
    (0, WEST, ["turn left", "turn left"]),
    # From South (1): West -> right (target 2 > current 1); East -> left.
    (1, WEST, ["turn right"]),
    (1, EAST, ["turn left"]),
    (1, NORTH, ["turn left", "turn left"]),
    # From West (2): North -> right; South -> left.
    (2, NORTH, ["turn right"]),
    (2, SOUTH, ["turn left"]),
    (2, EAST, ["turn left", "turn left"]),
    # From North (3): East -> right; West -> left.
    (3, EAST, ["turn right"]),
    (3, WEST, ["turn left"]),
    (3, SOUTH, ["turn left", "turn left"]),
])
def test_turn_to_direction(start, target, expected):
    world = _world()
    world.clear_situation()
    world.place_agent_at(Position(row=3, column=3))
    world.agent_dir = start
    world.turn_to_direction(target)
    commands, _ = world.get_current_observations()
    assert commands == expected


def test_go_to_position_west_then_north():
    """Column corrections come before row corrections."""
    world = _world()
    world.clear_situation()
    world.place_agent_at(Position(row=4, column=4))
    world.agent_dir = 0  # East
    world.go_to_position(Position(row=1, column=2), manner=None,
                         primitive_command="walk")
    commands, _ = world.get_current_observations()
    assert commands == ["turn left", "turn left", "walk", "walk",
                        "turn right", "walk", "walk", "walk"]
    assert world.agent_pos == (2, 1)


def test_zigzag_route():
    """Zigzag alternates axes until in line with the goal, then goes straight."""
    world = _world()
    world.clear_situation()
    world.place_agent_at(Position(row=0, column=0))
    world.agent_dir = 0  # East, goal to the south-east
    world.go_to_position(Position(row=3, column=3), manner="while zigzagging",
                         primitive_command="walk")
    commands, _ = world.get_current_observations()
    assert world.agent_pos == (3, 3)
    # First step east, then alternating turn/step pairs.
    assert commands[0] == "walk"
    assert commands[1].startswith("turn")
    walks = [c for c in commands if c == "walk"]
    assert len(walks) == 6  # 3 east + 3 south


def test_spin_and_hesitate_manners():
    world = _world()
    world.clear_situation()
    world.place_agent_at(Position(row=0, column=0))
    world.agent_dir = 0
    world.go_to_position(Position(row=0, column=2), manner="while spinning",
                         primitive_command="walk")
    commands, _ = world.get_current_observations()
    assert commands == ["turn left"] * 4 + ["walk"] + ["turn left"] * 4 + \
        ["walk"]

    world.clear_situation()
    world.place_agent_at(Position(row=0, column=0))
    world.agent_dir = 0
    world.go_to_position(Position(row=0, column=2), manner="hesitantly",
                         primitive_command="walk")
    commands, _ = world.get_current_observations()
    assert commands == ["walk", "stay", "walk", "stay"]


def test_cautious_manner():
    world = _world()
    world.clear_situation()
    world.place_agent_at(Position(row=0, column=0))
    world.agent_dir = 0
    world.go_to_position(Position(row=0, column=1), manner="cautiously",
                         primitive_command="walk")
    commands, _ = world.get_current_observations()
    assert commands == ["turn left", "turn right", "turn right", "turn left",
                        "walk"]


def test_push_light_object_to_wall():
    world = _world(grid_size=4)
    world.clear_situation()
    world.place_agent_at(Position(row=0, column=1))
    world.agent_dir = 0  # facing East
    world.place_object(Object(size=1, color="red", shape="circle"),
                       Position(row=0, column=1), target=True)
    world.move_object_to_wall(action="push", manner=None)
    commands, _ = world.get_current_observations()
    # Object from col 1 to col 3 (wall at col 3): two pushes; the agent
    # steps along with each push, ending on the object's cell.
    assert commands == ["push", "push"]
    assert world.grid_get(3, 0) is not None
    assert world.agent_pos == (3, 0)


def test_push_heavy_object_needs_double_push():
    world = _world(grid_size=4)
    world.clear_situation()
    world.place_agent_at(Position(row=0, column=1))
    world.agent_dir = 0
    world.place_object(Object(size=4, color="red", shape="circle"),
                       Position(row=0, column=1), target=True)
    world.move_object_to_wall(action="push", manner=None)
    commands, _ = world.get_current_observations()
    assert commands == ["push"] * 4  # two cells, two pushes each
    assert world.grid_get(3, 0) is not None


def test_pull_moves_agent_backwards():
    world = _world(grid_size=4)
    world.clear_situation()
    world.place_agent_at(Position(row=0, column=2))
    world.agent_dir = 0  # facing East -> pull direction is West
    world.place_object(Object(size=1, color="red", shape="circle"),
                       Position(row=0, column=2), target=True)
    world.move_object_to_wall(action="pull", manner=None)
    commands, _ = world.get_current_observations()
    assert commands == ["pull", "pull"]
    assert world.grid_get(0, 0) is not None  # object at col 0
    assert world.agent_pos == (0, 0)


def test_push_blocked_by_object():
    world = _world(grid_size=5)
    world.clear_situation()
    world.place_agent_at(Position(row=0, column=1))
    world.agent_dir = 0
    world.place_object(Object(size=1, color="red", shape="circle"),
                       Position(row=0, column=1), target=True)
    world.place_object(Object(size=2, color="blue", shape="square"),
                       Position(row=0, column=3))
    world.move_object_to_wall(action="push", manner=None)
    commands, _ = world.get_current_observations()
    # One push moves object to col 2; the next cell (3) is blocked -> loop ends.
    assert commands == ["push"]
    assert world.grid_get(2, 0) is not None


def test_execute_command_replay_matches():
    world = _world(grid_size=5)
    world.clear_situation()
    world.place_agent_at(Position(row=2, column=0))
    world.agent_dir = 0
    for command in ["walk", "walk", "turn right", "walk"]:
        world.execute_command(command)
    commands, situations = world.get_current_observations()
    assert commands == ["walk", "walk", "turn right", "walk"]
    assert world.agent_pos == (2, 3)
    assert len(situations) == 4
