"""Object vocabulary: the (size, color, shape) attribute space and object vectors.

Object vectors are ``one-hot(size) ++ one-hot(color|shape index space)`` exactly as
the reference builds them (cf. reference GroundedScan/world.py:323-434): first
``n_sizes`` entries one-hot the size, the remainder one-hot color and shape in the
order the shape/color word lists were passed in.
"""

import itertools
import random
from itertools import product
from typing import Dict, List

import numpy as np


def _one_hot(size: int, idx: int) -> np.ndarray:
    v = np.zeros(size, dtype=int)
    v[idx] = 1
    return v


class ObjectVocabulary:

    SIZES = list(range(1, 5))

    def __init__(self, shapes: List[str], colors: List[str], min_size: int,
                 max_size: int, rng: random.Random = None):
        """``rng`` draws the sampled sizes and colors (a fresh unseeded
        generator if None)."""
        assert self.SIZES[0] <= min_size <= max_size <= self.SIZES[-1], (
            "Unsupported object sizes (min: {}, max: {}) specified.".format(
                min_size, max_size))
        self._min_size = min_size
        self._max_size = max_size
        self._rng = rng if rng is not None else random.Random()

        self._shapes = set(shapes)
        self._n_shapes = len(self._shapes)
        self._colors = set(colors)
        self._n_colors = len(self._colors)
        self._idx_to_shapes_and_colors = shapes + colors
        self._shapes_and_colors_to_idx = {
            token: i for i, token in enumerate(self._idx_to_shapes_and_colors)}
        self._sizes = list(range(min_size, max_size + 1))
        self._n_sizes = len(self._sizes)
        assert (self._n_sizes % 2) == 0, (
            "Please specify an even amount of sizes (needs to be split in 2 classes.)")
        self._middle_size = (max_size + min_size) // 2

        # Weight classes: smaller half is light, larger half heavy.
        self._object_class = {i: "light"
                              for i in range(min_size, self._middle_size + 1)}
        self._object_class.update({i: "heavy"
                                   for i in range(self._middle_size + 1, max_size + 1)})

        self._object_vector_size = self._n_shapes + self._n_colors + self._n_sizes
        self._object_vectors = self._generate_objects()
        self._possible_colored_objects = {
            color + " " + shape
            for color, shape in itertools.product(self._colors, self._shapes)}

    def has_object(self, shape: str, color: str, size: int) -> bool:
        return (shape in self._shapes and color in self._colors
                and size in self._sizes)

    def object_in_class(self, size: int) -> str:
        return self._object_class[size]

    @property
    def num_object_attributes(self) -> int:
        return len(self._idx_to_shapes_and_colors) + self._n_sizes

    @property
    def smallest_size(self) -> int:
        return self._min_size

    @property
    def largest_size(self) -> int:
        return self._max_size

    @property
    def object_shapes(self) -> List[str]:
        return list(self._shapes.copy())

    @property
    def object_sizes(self) -> List[int]:
        return self._sizes.copy()

    @property
    def object_colors(self) -> List[str]:
        return list(self._colors.copy())

    @property
    def all_objects(self):
        return product(self.object_sizes, self.object_colors, self.object_shapes)

    def sample_size(self) -> int:
        return self._rng.choice(self._sizes)

    def sample_color(self) -> str:
        return self._rng.choice(list(self._colors))

    def get_object_vector(self, shape: str, color: str, size: int) -> np.ndarray:
        assert self.has_object(shape, color, size), (
            "Trying to get an unavailable object vector from the vocabulary.")
        return self._object_vectors[shape][color][size]

    def _generate_objects(self) -> Dict[str, Dict[str, Dict[int, np.ndarray]]]:
        vectors = {}
        for size, color, shape in itertools.product(self._sizes, self._colors,
                                                    self._shapes):
            offset = self._n_sizes
            vec = (_one_hot(self._object_vector_size, size - 1)
                   + _one_hot(self._object_vector_size,
                              self._shapes_and_colors_to_idx[color] + offset)
                   + _one_hot(self._object_vector_size,
                              self._shapes_and_colors_to_idx[shape] + offset))
            vectors.setdefault(shape, {}).setdefault(color, {})[size] = vec
        return vectors
