"""Value types for the gSCAN world: positions, objects, situations, logical forms.

Serialization formats (``to_representation`` / ``from_representation``) are kept
byte-compatible with the reference dataset files (cf. reference
GroundedScan/world.py:189-320) so that ``dataset.txt`` files interoperate.
"""

from collections import namedtuple
from typing import List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Basic named tuples
# ---------------------------------------------------------------------------

SemType = namedtuple("SemType", "name")
Position = namedtuple("Position", "column row")
Object = namedtuple("Object", "size color shape")
PositionedObject = namedtuple("PositionedObject", "object position vector",
                              defaults=(None, None, None))
Variable = namedtuple("Variable", "name sem_type")
_weight_fields = ("action", "is_transitive", "manner", "adjective_type", "noun")
Weights = namedtuple("Weights", _weight_fields, defaults=(None,) * len(_weight_fields))

ENTITY = SemType("noun")
COLOR = SemType("color")
SIZE = SemType("size")
EVENT = SemType("verb")

Direction = namedtuple("Direction", "name")
NORTH = Direction("north")
SOUTH = Direction("south")
WEST = Direction("west")
EAST = Direction("east")

# Agent headings use minigrid's integer convention: 0=E, 1=S, 2=W, 3=N.
DIR_TO_INT = {NORTH: 3, SOUTH: 1, WEST: 2, EAST: 0}
INT_TO_DIR = {v: k for k, v in DIR_TO_INT.items()}

# Integer direction -> (dcol, drow) step vector.
DIR_TO_VEC = {
    0: (1, 0),    # east
    1: (0, 1),    # south
    2: (-1, 0),   # west
    3: (0, -1),   # north
}

DIR_STR_TO_DIR = {"n": NORTH, "e": EAST, "s": SOUTH, "w": WEST}

# (clipped column-delta, clipped inverted row-delta) -> compass direction string.
DIR_VEC_TO_DIR = {
    (1, 0): "e", (0, 1): "n", (-1, 0): "w", (0, -1): "s",
    (1, 1): "ne", (1, -1): "se", (-1, -1): "sw", (-1, 1): "nw",
}

SIZE_TO_INT = {"small": 1, "average": 2, "big": 3}


# ---------------------------------------------------------------------------
# Serialization helpers (dataset.txt wire format)
# ---------------------------------------------------------------------------

def object_to_repr(obj: Object) -> dict:
    return {"shape": obj.shape, "color": obj.color, "size": str(obj.size)}


def position_to_repr(position: Position) -> dict:
    return {"row": str(position.row), "column": str(position.column)}


def positioned_object_to_repr(positioned_object: PositionedObject) -> dict:
    return {
        "vector": "".join(str(int(idx)) for idx in positioned_object.vector),
        "position": position_to_repr(positioned_object.position),
        "object": object_to_repr(positioned_object.object),
    }


def parse_object_repr(object_repr: dict) -> Object:
    return Object(shape=object_repr["shape"], color=object_repr["color"],
                  size=int(object_repr["size"]))


def parse_position_repr(position_repr: dict) -> Position:
    return Position(column=int(position_repr["column"]), row=int(position_repr["row"]))


def parse_object_vector_repr(object_vector_repr: str) -> np.ndarray:
    return np.array([int(idx) for idx in object_vector_repr])


def parse_positioned_object_repr(positioned_object_repr: dict) -> PositionedObject:
    return PositionedObject(
        object=parse_object_repr(positioned_object_repr["object"]),
        position=parse_position_repr(positioned_object_repr["position"]),
        vector=parse_object_vector_repr(positioned_object_repr["vector"]))


# ---------------------------------------------------------------------------
# Situation
# ---------------------------------------------------------------------------

class Situation:
    """Serializable snapshot of a world state (grid size, agent, objects, target)."""

    def __init__(self, grid_size: int, agent_position: Position,
                 agent_direction: Direction, target_object: PositionedObject,
                 placed_objects: List[PositionedObject], carrying: Object = None):
        self.grid_size = grid_size
        self.agent_pos = agent_position  # Position(column, row)
        self.agent_direction = agent_direction
        self.placed_objects = placed_objects
        self.carrying = carrying
        self.target_object = target_object

    @property
    def distance_to_target(self) -> int:
        """Manhattan distance from the agent to the target object."""
        return (abs(self.agent_pos.column - self.target_object.position.column)
                + abs(self.agent_pos.row - self.target_object.position.row))

    @property
    def direction_to_target(self) -> str:
        """8-way compass direction from agent to target ('n', 'sw', ...)."""
        column_distance = self.target_object.position.column - self.agent_pos.column
        column_distance = min(max(-1, column_distance), 1)
        row_distance = self.agent_pos.row - self.target_object.position.row
        row_distance = min(max(-1, row_distance), 1)
        return DIR_VEC_TO_DIR[(column_distance, row_distance)]

    def to_representation(self) -> dict:
        return {
            "grid_size": self.grid_size,
            "agent_position": position_to_repr(self.agent_pos),
            "agent_direction": DIR_TO_INT[self.agent_direction],
            "target_object": (positioned_object_to_repr(self.target_object)
                              if self.target_object else None),
            "distance_to_target": (str(self.distance_to_target)
                                   if self.target_object else None),
            "direction_to_target": (self.direction_to_target
                                    if self.target_object else None),
            "placed_objects": {str(i): positioned_object_to_repr(obj)
                               for i, obj in enumerate(self.placed_objects)},
            "carrying_object": object_to_repr(self.carrying) if self.carrying else None,
        }

    @classmethod
    def from_representation(cls, rep: dict) -> "Situation":
        target_object = rep["target_object"]
        carrying_object = rep["carrying_object"]
        placed_objects = [parse_positioned_object_repr(r)
                          for r in rep["placed_objects"].values()]
        return cls(
            grid_size=rep["grid_size"],
            agent_position=parse_position_repr(rep["agent_position"]),
            agent_direction=INT_TO_DIR[rep["agent_direction"]],
            target_object=(parse_positioned_object_repr(target_object)
                           if target_object else None),
            placed_objects=placed_objects,
            carrying=parse_object_repr(carrying_object) if carrying_object else None)

    def __eq__(self, other) -> bool:
        def compare(v1, v2) -> bool:
            if isinstance(v1, dict):
                for k, sub1 in v1.items():
                    sub2 = v2.get(k)
                    if not sub2 and sub1:
                        return False
                    if not compare(sub1, sub2):
                        return False
                return True
            return v1 == v2
        return compare(self.to_representation(), other.to_representation())


# ---------------------------------------------------------------------------
# Neo-Davidsonian logical forms (cf. reference GroundedScan/world.py:89-186)
# ---------------------------------------------------------------------------

class Term:
    """A predicate over variables, e.g. ``(walk x0:verb)``."""

    def __init__(self, function: str, args: tuple, weights=None, meta=None, specs=None):
        self.function = function
        self.arguments = args
        self.weights = weights
        self.meta = meta
        self.specs = specs

    def replace(self, var_to_find: Variable, replace_by_var: Variable) -> "Term":
        return Term(
            function=self.function,
            args=tuple(replace_by_var if v == var_to_find else v
                       for v in self.arguments),
            specs=self.specs, meta=self.meta)

    def to_predicate(self, predicate: dict):
        assert self.specs is not None
        if self.specs.noun:
            predicate["noun"] = self.function
        elif self.specs.adjective_type == SIZE:
            predicate["size"] = self.function
        elif self.specs.adjective_type == COLOR:
            predicate["color"] = self.function

    def __repr__(self):
        parts = [self.function] + ["{}:{}".format(v.name, v.sem_type.name)
                                   for v in self.arguments]
        return "({})".format(" ".join(parts))


class LogicalForm:
    """A conjunction of terms over shared variables; head is the first variable."""

    def __init__(self, variables: Tuple[Variable, ...], terms: Tuple[Term, ...]):
        self.variables = variables
        self.terms = terms
        if len(variables) > 0:
            self.head = variables[0]

    def bind(self, bind_var: Variable) -> "LogicalForm":
        """Bind this LF's head variable to ``bind_var`` (modifier attachment)."""
        sub_var, variables_out = self.variables[0], self.variables[1:]
        terms_out = [term.replace(sub_var, bind_var) for term in self.terms]
        return LogicalForm(variables=(bind_var,) + variables_out,
                           terms=tuple(terms_out))

    def select(self, variables: list, exclude=frozenset()) -> "LogicalForm":
        """Sub-LF reachable from ``variables`` through term arguments."""
        queue = list(variables)
        used_vars = set()
        terms_out = []
        while len(queue) > 0:
            var = queue.pop()
            deps = [t for t in self.terms
                    if t.function not in exclude and t.arguments[0] == var]
            for term in deps:
                terms_out.append(term)
                used_vars.add(var)
                for v in term.arguments[1:]:
                    if v not in used_vars:
                        queue.append(v)
        vars_out = [v for v in self.variables if v in used_vars]
        terms_out = list(set(terms_out))
        return LogicalForm(tuple(vars_out), tuple(terms_out))

    def to_predicate(self) -> Tuple[str, dict]:
        """Extract {noun, size, color} and the '[color] noun' reference string."""
        assert len(self.variables) == 1
        predicate = {"noun": "", "size": "", "color": ""}
        for term in self.terms:
            term.to_predicate(predicate)
        object_str = ""
        if predicate["color"]:
            object_str += " " + predicate["color"]
        object_str += " " + predicate["noun"]
        return object_str.strip(), predicate

    def __repr__(self):
        return "LF({})".format(" ^ ".join(repr(t) for t in self.terms))


def topo_sort(items, constraints):
    """Order ``items`` respecting (before, after) ``constraints`` (event 'seq' order)."""
    if not constraints:
        return items
    items = list(items)
    constraints = list(constraints)
    out = []
    while len(items) > 0:
        roots = [i for i in items if not any(c[1] == i for c in constraints)]
        assert len(roots) > 0, (items, constraints)
        to_pop = roots[0]
        items.remove(to_pop)
        constraints = [c for c in constraints if c[0] != to_pop]
        out.append(to_pop)
    return out


def generate_possible_object_names(color: str, shape: str) -> List[str]:
    """All referring expressions an object answers to: 'circle', 'red circle'."""
    return [shape, " ".join([color, shape])]
