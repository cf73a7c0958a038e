"""A run without a card, and whole runs of small cells on the CPU that a
checkout gains by adding files and entries alone."""

import json
import subprocess
import sys

import pytest

from benchmark.tests import tiny


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("checkout"))


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    done = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "baseline.train_k50", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=tiny.REPO, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert done.returncode != 0
    assert "{" not in done.stdout


def test_run_without_the_program_exits_nonzero(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark."""
    import shutil
    shutil.copytree(tiny.REPO / "benchmark", tmp_path / "benchmark")
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    code = ("import sys, time; sys.path.insert(0, '.'); "
            "from benchmark.harness.core import run_cell; "
            "run_cell('baseline.train_k50', 1, 1, False, 'cpu', time.time())")
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert "{" not in done.stdout


@pytest.mark.parametrize("cell,trace", [
    ("tiny.train", False), ("tiny.train", True),
    ("tiny.decode", False), ("tiny.decode", True)])
def test_a_cell_added_by_files_runs(checkout, cell, trace):
    result = tiny.run(checkout, cell, trace=trace)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    if trace:
        wanted = {m["name"] for m in spec["per_layer"]
                  if cell in m["workloads"]}
        assert set(result["metrics"]) <= wanted
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        wanted = {m["name"] for m in spec["end_to_end"]
                  if cell in m.get("workloads", [cell])}
        assert set(result["metrics"]) == wanted
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"}


def test_the_same_seed_gives_the_same_inputs(checkout):
    a = tiny.run(checkout, "tiny.train", seed=2**31 + 99)
    b = tiny.run(checkout, "tiny.train", seed=2**31 + 99)
    assert a["checks"] == b["checks"]
