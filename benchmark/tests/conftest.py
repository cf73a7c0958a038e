"""The benchmark's own tests. They import neither JAX nor the JAX package
(the card's machine has none), so no conftest of ``tests/`` is needed:

    python -m pytest benchmark/tests -q

Tests that need the card carry the ``cuda`` marker and skip without one.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels)")
