"""Gridworld simulator and oracle demonstration planner.

A dependency-free rewrite of the reference's minigrid-based world (reference
GroundedScan/world.py:437-985 + gym_minigrid/minigrid.py): no gym, no PyQt5 —
state is a plain dict grid plus the agent pose; rendering lives in
``analysis.render`` (headless rasterizer).

Behavioral contract (pinned by golden tests in tests/test_oracle.py):
- action vocabulary {walk, push, pull, stay, turn left, turn right};
- direction ints 0=E 1=S 2=W 3=N; turn resolution of ``turn_to_direction``;
- west/east-then-north/south route planning in ``go_to_position``;
- zigzag planner, spin/cautious/hesitant manner transforms and their exact
  placement inside walk and push loops;
- heavy objects need two pushes per cell (momentum).
"""

import itertools
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from multimodal_seq2seq_gscan_tpu_torch.gscan.object_vocabulary import ObjectVocabulary
from multimodal_seq2seq_gscan_tpu_torch.gscan.types import (
    DIR_STR_TO_DIR, DIR_TO_INT, DIR_TO_VEC, EAST, INT_TO_DIR, NORTH, SOUTH, WEST,
    Direction, Object, Position, PositionedObject, Situation,
    generate_possible_object_names)

WEIGHT_TO_MOMENTUM = {"light": 1, "heavy": 2}

# (higher-level) action names the replay executor understands.
REPLAYABLE_VERBS = {"walk", "run", "jump", "push", "pull", "stay", "turn"}


class CellObject:
    """An object sitting on the grid: attributes plus push momentum state."""

    __slots__ = ("type", "color", "size", "vector_representation",
                 "object_representation", "target", "weight", "momentum",
                 "momentum_threshold")

    def __init__(self, object_spec: Object, vector: np.ndarray, target: bool,
                 weight: str):
        self.type = object_spec.shape
        self.color = object_spec.color
        self.size = object_spec.size
        self.vector_representation = vector
        self.object_representation = object_spec
        self.target = target
        self.weight = weight
        self.momentum = 0
        self.momentum_threshold = WEIGHT_TO_MOMENTUM[weight]

    def can_push(self) -> bool:
        return True

    def push(self) -> bool:
        """One push; heavy objects only move every ``momentum_threshold``-th push."""
        self.momentum += 1
        if self.momentum >= self.momentum_threshold:
            self.momentum = 0
            return True
        return False


class World:
    """Stateful gridworld: object placement, agent motion, oracle demonstrations.

    Every executed primitive appends (command, situation) to the observation log,
    retrievable with :meth:`get_current_observations`.
    """

    AVAILABLE_SHAPES = {"circle", "square", "cylinder"}
    AVAILABLE_COLORS = {"red", "blue", "green", "yellow"}

    def __init__(self, grid_size: int, shapes: List[str], colors: List[str],
                 object_vocabulary: ObjectVocabulary, save_directory: str = "",
                 rng: random.Random = None):
        """``rng`` draws the sampled positions (a fresh unseeded generator
        if None)."""
        for shape in shapes:
            assert shape in self.AVAILABLE_SHAPES, (
                "Specified shape {} not implemented in world.".format(shape))
        for color in colors:
            assert color in self.AVAILABLE_COLORS, (
                "Specified color {} not implemented in world.".format(color))

        self.grid_size = grid_size
        self.save_directory = save_directory
        self._rng = rng if rng is not None else random.Random()
        self._object_vocabulary = object_vocabulary
        self.mission = None

        # Live state.
        self._grid: Dict[Tuple[int, int], CellObject] = {}  # (col, row) -> object
        self.agent_pos: Tuple[int, int] = (0, 0)  # (column, row)
        self.agent_dir: int = DIR_TO_INT[EAST]
        self.carrying: Optional[CellObject] = None

        self._placed_object_list: List[PositionedObject] = []
        self._target_object: Optional[PositionedObject] = None
        self._observed_commands: List[str] = []
        self._observed_situations: List[Situation] = []
        self._occupied_positions = set()
        # Lookup of positions by partial reference ("circle", "red circle") and size.
        self._object_lookup_table: Dict[str, Dict[int, List[Position]]] = {}

    # ------------------------------------------------------------------
    # Grid primitives
    # ------------------------------------------------------------------

    def grid_get(self, column: int, row: int) -> Optional[CellObject]:
        return self._grid.get((column, row))

    def position_taken(self, position: Position) -> bool:
        return self.grid_get(position.column, position.row) is not None

    def within_grid(self, position: Position) -> bool:
        return (0 <= position.row < self.grid_size
                and 0 <= position.column < self.grid_size)

    @property
    def front_pos(self) -> Tuple[int, int]:
        dcol, drow = DIR_TO_VEC[self.agent_dir]
        return (self.agent_pos[0] + dcol, self.agent_pos[1] + drow)

    # ------------------------------------------------------------------
    # Initialization / placement
    # ------------------------------------------------------------------

    def initialize(self, objects: List[Tuple[Object, Position]],
                   agent_position: Position, agent_direction: Direction,
                   target_object: Optional[PositionedObject],
                   carrying: Object = None):
        """Build the world from a list of placed objects plus agent pose."""
        self.clear_situation()
        self.agent_dir = DIR_TO_INT[agent_direction]
        self.place_agent_at(agent_position)
        self._target_object = target_object
        for current_object, current_position in objects:
            target = bool(target_object
                          and target_object.position == current_position)
            self.place_object(current_object, current_position, target=target)
        if carrying:
            carrying_object = self.create_object(
                carrying, self._object_vocabulary.get_object_vector(
                    carrying.shape, carrying.color, carrying.size))
            self.carrying = carrying_object

    def create_object(self, object_spec: Object, object_vector: np.ndarray,
                      target: bool = False) -> CellObject:
        assert object_spec.shape in self.AVAILABLE_SHAPES, (
            "Trying to create an object shape {} that is not implemented.".format(
                object_spec.shape))
        return CellObject(object_spec, object_vector, target=target,
                          weight=self._object_vocabulary.object_in_class(
                              object_spec.size))

    def place_agent_at(self, position: Position):
        if not self.position_taken(position):
            self.agent_pos = (position.column, position.row)
            self._occupied_positions.add((position.column, position.row))
        else:
            raise ValueError("Trying to place agent on cell that is already taken.")

    def place_object(self, object_spec: Object, position: Position,
                     target: bool = False):
        if not self.within_grid(position):
            raise IndexError(
                "Trying to place object '{}' outside of grid of size {}.".format(
                    object_spec.shape, self.grid_size))
        if self.position_taken(position):
            # Overlapping objects are unsupported; skip silently like the reference.
            return
        object_vector = self._object_vocabulary.get_object_vector(
            shape=object_spec.shape, color=object_spec.color, size=object_spec.size)
        positioned_object = PositionedObject(object=object_spec, position=position,
                                             vector=object_vector)
        self._grid[(position.column, position.row)] = self.create_object(
            object_spec, object_vector, target=target)
        self._placed_object_list.append(positioned_object)
        self._add_object_to_lookup_table(positioned_object)
        self._occupied_positions.add((position.column, position.row))
        if target:
            self._target_object = positioned_object

    def _add_object_to_lookup_table(self, positioned_object: PositionedObject):
        object_size = positioned_object.object.size
        object_names = generate_possible_object_names(
            color=positioned_object.object.color,
            shape=positioned_object.object.shape)
        for name in object_names:
            if name not in self._object_lookup_table:
                self._object_lookup_table[name] = {}
            # Reset per-size buckets the first time this exact size shows up so
            # multiple identical objects can coexist (reference world.py:628-633).
            if object_size not in self._object_lookup_table[name]:
                self._object_lookup_table[name] = {
                    size: [] for size in self._object_vocabulary.object_sizes}
            self._object_lookup_table[name][object_size].append(
                positioned_object.position)

    def _remove_object(self, target_position: Position) -> PositionedObject:
        target_object = None
        for i, positioned_object in enumerate(self._placed_object_list):
            if positioned_object.position == target_position:
                target_object = self._placed_object_list[i]
                del self._placed_object_list[i]
                break
        self._remove_object_from_lookup_table(target_object)
        del self._grid[(target_position.column, target_position.row)]
        self._occupied_positions.remove((target_position.column,
                                         target_position.row))
        return target_object

    def _remove_object_from_lookup_table(self,
                                         positioned_object: PositionedObject):
        for name in generate_possible_object_names(
                positioned_object.object.color, positioned_object.object.shape):
            self._object_lookup_table[name][positioned_object.object.size].remove(
                positioned_object.position)

    def move_object(self, old_position: Position, new_position: Position):
        old_positioned_object = self._remove_object(old_position)
        if not old_positioned_object:
            raise ValueError(
                "Trying to move an object from an empty grid location "
                "(row {}, col {})".format(old_position.row, old_position.column))
        self.place_object(old_positioned_object.object, new_position)

    # ------------------------------------------------------------------
    # Position sampling (dataset generation)
    # ------------------------------------------------------------------

    def sample_position(self) -> Position:
        available_positions = [
            (row, col) for row, col in itertools.product(range(self.grid_size),
                                                         range(self.grid_size))
            if (col, row) not in self._occupied_positions]
        sampled_position = self._rng.sample(available_positions, 1).pop()
        return Position(row=sampled_position[0], column=sampled_position[1])

    def sample_position_conditioned(self, north: int, east: int, south: int,
                                    west: int) -> Position:
        """Sample a position with at least the given free steps per direction."""
        assert north == 0 or south == 0, (
            "Can't take steps in both North and South direction")
        assert east == 0 or west == 0, (
            "Can't take steps in both East and West direction")
        max_col = self.grid_size - east if east > 0 else self.grid_size - 1
        min_col = west - 1 if west > 0 else 0
        max_row = self.grid_size - south if south > 0 else self.grid_size - 1
        min_row = north - 1 if north > 0 else 0
        available_positions = [(row, col)
                               for col in range(min_col, max_col + 1)
                               for row in range(min_row, max_row + 1)]
        sampled_position = self._rng.sample(available_positions, 1).pop()
        return Position(row=sampled_position[0], column=sampled_position[1])

    @staticmethod
    def get_position_at(current_position: Position, direction_str: str,
                        distance: int) -> Position:
        """Position ``distance`` straight steps away in a cardinal direction."""
        direction = DIR_STR_TO_DIR[direction_str]
        dcol, drow = DIR_TO_VEC[DIR_TO_INT[direction]]
        return Position(column=current_position.column + dcol * distance,
                        row=current_position.row + drow * distance)

    # ------------------------------------------------------------------
    # Primitive agent steps
    # ------------------------------------------------------------------

    def _record(self, command: str):
        self._observed_commands.append(command)
        self._observed_situations.append(self.get_current_situation())

    def turn_left(self):
        self.agent_dir = (self.agent_dir - 1) % 4

    def turn_right(self):
        self.agent_dir = (self.agent_dir + 1) % 4

    def step_forward(self):
        fwd = self.front_pos
        # Objects can always be overlapped; only grid bounds block movement --
        # callers check within_grid before stepping.
        self.agent_pos = fwd

    def take_step(self, action: str, observed_command: str):
        """Execute a primitive ('left'|'right'|'forward') and record it."""
        if action == "left":
            self.turn_left()
        elif action == "right":
            self.turn_right()
        elif action == "forward":
            self.step_forward()
        else:
            raise ValueError("Unknown primitive action {}".format(action))
        self._record(observed_command)

    def turn_to_direction(self, direction: Direction):
        """Turn (recording each quarter-turn) until facing ``direction``."""
        current_direction = self.agent_dir
        target_direction = DIR_TO_INT[direction]
        if current_direction == target_direction:
            return
        cur_vec = np.array(DIR_TO_VEC[current_direction])
        tgt_vec = np.array(DIR_TO_VEC[target_direction])
        if np.linalg.norm(tgt_vec - cur_vec) >= 2:
            self.take_step("left", "turn left")
            self.take_step("left", "turn left")
        else:
            if current_direction == 0:  # East
                turn = "right" if target_direction == 1 else "left"
            elif current_direction == 3:  # North
                turn = "right" if target_direction == 0 else "left"
            else:  # South and West
                turn = "right" if target_direction > current_direction else "left"
            self.take_step(turn, "turn {}".format(turn))

    def take_step_in_direction(self, direction: Direction, primitive_command: str):
        """Turn to ``direction`` (if needed) then step forward, recording the verb."""
        if DIR_TO_INT[direction] != self.agent_dir:
            self.turn_to_direction(direction)
        if self.within_grid(Position(column=self.front_pos[0],
                                     row=self.front_pos[1])):
            self.step_forward()
            self._observed_commands.append(primitive_command)
            self._observed_situations.append(self.get_current_situation())

    # ------------------------------------------------------------------
    # Manner behaviors
    # ------------------------------------------------------------------

    def look_left_and_right(self):
        self.take_step("left", "turn left")
        self.take_step("right", "turn right")
        self.take_step("right", "turn right")
        self.take_step("left", "turn left")

    def hesitate(self):
        self._record("stay")

    def spin(self):
        for _ in range(4):
            self.take_step("left", "turn left")

    def move_with_manners(self, direction: Direction, manner: str,
                          primitive_command: str):
        if manner == "while spinning":
            self.spin()
            self.take_step_in_direction(direction, primitive_command)
        elif manner == "cautiously":
            self.turn_to_direction(direction)
            self.look_left_and_right()
            self.take_step_in_direction(direction, primitive_command)
        else:
            self.take_step_in_direction(direction, primitive_command)
        if manner == "hesitantly":
            self.hesitate()

    # ------------------------------------------------------------------
    # Route planning
    # ------------------------------------------------------------------

    def agent_in_line_with_goal(self, goal: Position) -> bool:
        return goal.column == self.agent_pos[0] or goal.row == self.agent_pos[1]

    def direction_to_goal(self, goal: Position):
        """Quadrant of the goal and the first zigzag turn (reference semantics)."""
        col_difference = max(goal.column - self.agent_pos[0], 0)
        row_difference = max(goal.row - self.agent_pos[1], 0)
        if col_difference and row_difference:
            return "SE", "left"
        elif col_difference and not row_difference:
            return "NE", "right"
        elif row_difference and not col_difference:
            return "SW", "right"
        else:
            return "NW", "left"

    def go_to_position(self, position: Position, manner: str,
                       primitive_command: str):
        """Walk to ``position``; manner transforms the recorded action sequence."""
        if manner == "while zigzagging" and not self.agent_in_line_with_goal(
                position):
            direction_to_goal, first_move = self.direction_to_goal(position)
            previous_step = first_move
            if direction_to_goal in ("NE", "SE"):
                self.take_step_in_direction(EAST, primitive_command)
            else:
                self.take_step_in_direction(WEST, primitive_command)
            while not self.agent_in_line_with_goal(position):
                if previous_step == "left":
                    self.take_step("right", "turn right")
                    previous_step = "right"
                else:
                    self.take_step("left", "turn left")
                    previous_step = "left"
                self.take_step("forward", primitive_command)
            # Finish the route not zigzagging.
            while self.agent_pos[0] > position.column:
                self.take_step_in_direction(WEST, primitive_command)
            while self.agent_pos[0] < position.column:
                self.take_step_in_direction(EAST, primitive_command)
            while self.agent_pos[1] > position.row:
                self.take_step_in_direction(NORTH, primitive_command)
            while self.agent_pos[1] < position.row:
                self.take_step_in_direction(SOUTH, primitive_command)
        else:
            while self.agent_pos[0] > position.column:
                self.move_with_manners(WEST, manner, primitive_command)
            while self.agent_pos[0] < position.column:
                self.move_with_manners(EAST, manner, primitive_command)
            while self.agent_pos[1] > position.row:
                self.move_with_manners(NORTH, manner, primitive_command)
            while self.agent_pos[1] < position.row:
                self.move_with_manners(SOUTH, manner, primitive_command)

    # ------------------------------------------------------------------
    # Object interaction (push / pull)
    # ------------------------------------------------------------------

    def empty_cell_in_direction(self, direction: Direction) -> bool:
        dcol, drow = DIR_TO_VEC[DIR_TO_INT[direction]]
        next_cell = (self.agent_pos[0] + dcol, self.agent_pos[1] + drow)
        if self.within_grid(Position(column=next_cell[0], row=next_cell[1])):
            return self.grid_get(*next_cell) is None
        return False

    def pull(self, position: Position):
        """Move the agent onto the pulled object's new cell, recording 'pull'."""
        self.agent_pos = (position.column, position.row)
        self._record("pull")

    def push_or_pull_object(self, direction: Direction, primitive_command: str):
        current_object = self.grid_get(*self.agent_pos)
        if not current_object:
            self._record(primitive_command)
            return
        assert current_object.can_push(), (
            "Trying to push an object that cannot be pushed")
        if current_object.push():
            dcol, drow = DIR_TO_VEC[DIR_TO_INT[direction]]
            new_position = Position(column=self.agent_pos[0] + dcol,
                                    row=self.agent_pos[1] + drow)
            if self.within_grid(new_position):
                if not self.grid_get(new_position.column, new_position.row):
                    self.move_object(Position(column=self.agent_pos[0],
                                              row=self.agent_pos[1]), new_position)
                    if primitive_command == "push":
                        self.take_step_in_direction(direction, primitive_command)
                    else:
                        self.pull(position=new_position)
        else:
            # Heavy object gaining momentum: push recorded, nothing moves yet.
            self._record(primitive_command)

    def move_object_to_wall(self, action: str, manner: str):
        """Push (facing direction) or pull (behind) the object under the agent
        until the next cell in that direction is blocked or out of grid."""
        if action == "push":
            direction = INT_TO_DIR[self.agent_dir]
        else:
            direction = INT_TO_DIR[(self.agent_dir + 2) % 4]
        while self.empty_cell_in_direction(direction=direction):
            if manner == "while spinning":
                self.spin()
            elif manner == "cautiously":
                self.look_left_and_right()
            self.push_or_pull_object(direction=direction, primitive_command=action)
            if manner == "hesitantly":
                self.hesitate()

    # ------------------------------------------------------------------
    # Replay executor (for predicted command sequences)
    # ------------------------------------------------------------------

    def execute_command(self, command_str: str):
        """Execute one observed command string, e.g. 'turn left', 'walk', 'push'."""
        command_list = command_str.split()
        verb = command_list[0]
        if len(command_list) > 1 and verb == "turn":
            direction = command_list[1]
            if direction == "left":
                self.take_step("left", "turn left")
            elif direction == "right":
                self.take_step("right", "turn right")
            else:
                raise ValueError("Trying to turn in an unknown direction")
        elif verb in ("walk", "run", "jump"):
            self.take_step_in_direction(
                direction=DIR_STR_TO_DIR[INT_TO_DIR[self.agent_dir].name[0]],
                primitive_command=verb)
        elif verb in ("push", "pull"):
            self.push_or_pull_object(
                direction=DIR_STR_TO_DIR[INT_TO_DIR[self.agent_dir].name[0]],
                primitive_command=verb)
        elif verb == "stay":
            return
        else:
            raise ValueError("Incorrect command {}.".format(command_str))

    # ------------------------------------------------------------------
    # Object lookup (target identification at demonstration time)
    # ------------------------------------------------------------------

    def has_object(self, object_str: str) -> bool:
        return object_str in self._object_lookup_table

    def object_positions(self, object_str: str,
                         object_size: str = None) -> List[Position]:
        assert self.has_object(object_str), (
            "Trying to get an object's position that is not placed in the world.")
        object_locations = self._object_lookup_table[object_str]
        if object_size:
            present_object_sizes = [size for size, objs in object_locations.items()
                                    if objs]
            present_object_sizes.sort()
            assert len(present_object_sizes) >= 2, (
                "referring to a {} object but only one of its size present.".format(
                    object_size))
            if object_size == "small":
                return list(object_locations[present_object_sizes[0]])
            elif object_size == "big":
                return list(object_locations[present_object_sizes[-1]])
            else:
                raise ValueError("Wrong size in term specifications.")
        # No size referred: every position of every size is a candidate.
        # (The reference returns dict items here, a latent bug never hit in
        #  generation because the target is pre-assigned; we return positions.)
        return [pos for positions in object_locations.values()
                for pos in positions]

    # ------------------------------------------------------------------
    # State capture
    # ------------------------------------------------------------------

    def get_current_situation_grid_repr(self) -> np.ndarray:
        """Dense [grid, grid, D+5] uint8 grid encoding (the model input tensor).

        Layout per cell (cf. reference minigrid.py:380-399 ``Grid.encode``):
        [object vector (D) | agent bit | one-hot agent direction (4)].
        """
        num_attributes = self._object_vocabulary.num_object_attributes
        array = np.zeros((self.grid_size, self.grid_size, num_attributes + 1 + 4),
                         dtype="uint8")
        for (col, row), cell in self._grid.items():
            array[row, col, :num_attributes] = cell.vector_representation
        agent_column, agent_row = self.agent_pos
        array[agent_row, agent_column, num_attributes] = 1
        array[agent_row, agent_column, num_attributes + 1 + self.agent_dir] = 1
        return array

    def get_current_situation(self) -> Situation:
        carrying = self.carrying.object_representation if self.carrying else None
        return Situation(
            grid_size=self.grid_size,
            agent_position=Position(column=self.agent_pos[0], row=self.agent_pos[1]),
            target_object=self._target_object,
            agent_direction=INT_TO_DIR[self.agent_dir],
            placed_objects=self._placed_object_list.copy(),
            carrying=carrying)

    def get_current_observations(self):
        return self._observed_commands.copy(), self._observed_situations.copy()

    def clear_situation(self):
        self._object_lookup_table.clear()
        self._placed_object_list.clear()
        self._observed_commands.clear()
        self._observed_situations.clear()
        self._occupied_positions.clear()
        self._grid.clear()
        self._target_object = None
        self.carrying = None
        self.agent_pos = (0, 0)
        self.agent_dir = DIR_TO_INT[EAST]

    def set_mission(self, mission: str):
        self.mission = mission
