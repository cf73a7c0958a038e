"""On the card, at each cell's own size: the program's numbers within the
cell's limits and the control's (the reference in TF32) beyond one of
them, on one seed (``benchmark/tools/calibrate.py`` reads a dozen).

    python -m pytest benchmark/tests/test_bench_card.py -m cuda
"""

import json
import subprocess
import sys

import pytest

from benchmark.tests.tiny import REPO

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cell_size(card, cell, tmp_path):
    seed = str(2**31 + 777)
    out = tmp_path / "readings.json"
    subprocess.run([sys.executable, "benchmark/tools/calibrate.py",
                    "--workload", cell, "--seeds", seed, "--control-seeds",
                    seed, "--out", str(out)], cwd=REPO, check=True,
                   timeout=1200)
    limits = json.loads((REPO / "benchmark" / "limits"
                         / (cell + ".json")).read_text())
    (row,) = json.loads(out.read_text())
    assert all(row["program"][n] <= limits[n] for n in row["program"])
    assert any(row["control"][n] > limits[n] for n in row["control"])
