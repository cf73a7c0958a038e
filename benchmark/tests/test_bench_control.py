"""The control, the reference in TF32 put in the program's place, fails
the cells' limits where the program passes them (small cells on the CPU,
held to the limits of the cells they stand for; the cells' own sizes are
read on the card by ``benchmark/tools/calibrate.py``)."""

import json
import subprocess
import sys

import pytest

from benchmark.tests import tiny

LIMITS = {cell: json.loads((tiny.REPO / "benchmark" / "limits"
                            / (real + ".json")).read_text())
          for cell, real in (("tiny.train", "baseline.train_k50"),
                             ("tiny.decode", "baseline.decode_16k"))}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.decode"])
def test_control_fails_where_the_program_passes(checkout, cell):
    out = checkout / (cell + ".json")
    seeds = "{},{}".format(2**31 + 21, 2**31 + 22)
    subprocess.run(
        [sys.executable, "benchmark/tools/calibrate.py", "--workload", cell,
         "--seeds", seeds, "--control-seeds", seeds, "--device", "cpu",
         "--out", str(out)], cwd=checkout, check=True, capture_output=True,
        timeout=600)
    limits = LIMITS[cell]
    for row in json.loads(out.read_text()):
        assert all(row["program"][n] <= limits[n] for n in row["program"])
        assert any(row["control"][n] > limits[n] for n in row["control"])
        assert any(row["fault"][n] > limits[n] for n in row["fault"])
