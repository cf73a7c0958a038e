"""BENCHMARK.json against the benchmark's contract, and every file that a
cell is found by."""

import json
import math
import re
from pathlib import Path


ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion", "experts_per_token")


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for path in SPEC["paths"]:
        assert PATH.match(path) and ".." not in path and not path.startswith(
            "/")
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(one_line(word) for word in SPEC["command"])
    named = [w for w in SPEC["command"] if "/" in w]
    assert all(any(w.startswith(p + "/") for p in SPEC["paths"])
               for w in named)
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51


def test_check_fits_the_day_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_texts():
    entries = (SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"]
               + SPEC["per_layer"])
    names = [e["name"] for e in entries]
    for name in names:
        assert NAME.match(name), name
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in SPEC[group]}) == len(SPEC[group])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for metric in metrics:
        assert UNIT.match(metric["unit"]), metric["unit"]
        assert metric["better"] in ("lower", "higher")
    for entry in SPEC["configs"] + SPEC["workloads"]:
        assert one_line(entry["why"])
    for metric in SPEC["per_layer"]:
        assert one_line(metric["layer"])


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for config in SPEC["configs"]:
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert config["name"] in used
        assert one_line(config["source"])
        assert config["source"].startswith("https://")
        assert any(config["file"].startswith(p + "/") for p in SPEC["paths"])
        assert config["file"] not in files
        files.add(config["file"])
        body = json.loads((ROOT / config["file"]).read_text())
        assert body["name"] == config["name"]
        assert body["reduced"] == config["reduced"]
        assert len(config["reduced"]) <= 16
        for key in config["reduced"]:
            assert NAME.match(key) and key in body
            assert not key.endswith(("_dim", "_rank", "_size"))
            assert not any(word in key for word in WIDTH_WORDS)


def test_workloads():
    assert 1 <= len(SPEC["workloads"]) <= 24
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = set()
    for cell in SPEC["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["config"] in configs and cell["chips"] in (1, 4)
        assert NAME.match(cell["traffic"])
        pairs.add((cell["config"], cell["traffic"]))
        traffic = json.loads(
            (ROOT / "benchmark" / "traffic" / (cell["traffic"] + ".json"))
            .read_text())
        assert (ROOT / "benchmark" / "drivers"
                / (traffic["driver"] + ".py")).is_file()
        assert (ROOT / "benchmark" / "limits"
                / (cell["name"] + ".json")).is_file()
    assert len(pairs) == len(SPEC["workloads"])
    fours = sum(1 for c in SPEC["workloads"] if c["chips"] == 4)
    assert fours <= max(1, math.floor(len(SPEC["workloads"]) / 4))


def reported(cell):
    return {m["name"] for m in SPEC["end_to_end"]
            if cell in m.get("workloads", [cell])}


def test_end_to_end_metrics():
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert names == {"setup_s", "train_ex_per_s", "decode_ex_per_s",
                     "decode_batch_p95_ms"}
    for metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
    cells = {c["name"] for c in SPEC["workloads"]}
    for cell in cells:
        assert "setup_s" in reported(cell) and len(reported(cell)) >= 2


def test_per_layer_metrics():
    assert 1 <= len(SPEC["per_layer"]) <= 128
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {c["name"] for c in SPEC["workloads"]}
    layers = {}
    for metric in SPEC["per_layer"]:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in e2e
        assert (ROOT / "benchmark" / "metrics"
                / (metric["name"] + ".py")).is_file()
        for cell in metric["workloads"]:
            assert cell in cells and metric["moves"] in reported(cell)
        if "roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"
        layers.setdefault(metric["layer"], set()).add(metric["name"])
    for cell in cells:
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


def test_perf_md_names_every_layer():
    perf = (ROOT / "PERF.md").read_text()
    for metric in SPEC["per_layer"]:
        assert metric["layer"] in perf, metric["layer"]
