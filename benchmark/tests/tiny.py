"""A checkout in a temporary directory whose ``BENCHMARK.json`` holds
small cells of the benchmark's drivers, added as files and entries alone
beside copies of the benchmark's own files: ``tiny.train`` (a new
configuration at H = 12, batch 8, 2-step chunks) and ``tiny.decode`` (the
trained baseline, 48 rows a batch). Its cells run on the CPU (the
program's plain versions) through ``run_cell``, which skips the look for
a chip."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PORT = "multimodal_seq2seq_gscan_tpu_torch"

TINY_CONFIG = dict(name="tiny", embedding_dimension=8,
                   encoder_hidden_size=12, decoder_hidden_size=12,
                   cnn_hidden_num_channels=6, training_batch_size=8)
TRAIN = {"driver": "train_resident", "steps_per_execution": 2,
         "print_every": 2, "evaluate_every": 2, "trace_units": 2}
DECODE = {"driver": "greedy_decode", "split": "dev", "batch_size": 48,
          "decode_impl": "block", "exit_check_every": 32,
          "warmup_batches": 1, "kept_random_rows": 6,
          "kept_longest_rows": 2, "checked_batches": 3, "trace_units": 2}


def build(tmp: Path, limits=None) -> Path:
    """The checkout: ``tiny.train`` and ``tiny.decode`` cells."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in ("data", PORT):
        (tmp / name).symlink_to(REPO / name)
    bench = tmp / "benchmark"
    with open(bench / "configs" / "gscan_baseline.json") as f:
        config = json.load(f)
    config.update(TINY_CONFIG)
    config.pop("checkpoint")
    (bench / "configs" / "tiny.json").write_text(json.dumps(config))
    (bench / "traffic" / "tiny_train.json").write_text(json.dumps(TRAIN))
    (bench / "traffic" / "tiny_decode.json").write_text(json.dumps(DECODE))
    for cell, real in (("tiny.train", "baseline.train_k50"),
                       ("tiny.decode", "baseline.decode_16k")):
        shutil.copy(bench / "limits" / (real + ".json"),
                    bench / "limits" / (cell + ".json"))
        if limits:
            (bench / "limits" / (cell + ".json")).write_text(
                json.dumps(limits[cell]))
    with open(REPO / "BENCHMARK.json") as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny", "source": "a test",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"] += [
        {"name": "tiny.train", "config": "tiny", "traffic": "tiny_train",
         "chips": 1, "why": "a test"},
        {"name": "tiny.decode", "config": "gscan_baseline",
         "traffic": "tiny_decode",
         "chips": 1, "why": "a test"}]
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in metric:
            kind = ("tiny.decode" if "decode" in metric["workloads"][0]
                    else "tiny.train")
            metric["workloads"].append(kind)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


def run(tmp: Path, cell: str, seed: int = 2**31 + 11, trace: bool = False,
        seconds: float = 0.5, before: str = "") -> dict:
    """One run of ``cell`` on the CPU in a fresh interpreter: its result
    object. ``before`` is Python run first (to plant a fault)."""
    code = "\n".join([
        "import json, sys, time",
        "sys.path.insert(0, {!r})".format(str(tmp)),
        "import torch",
        "torch.set_num_threads(2)",
        before,
        "from benchmark.harness.core import run_cell",
        "result = run_cell({!r}, {}, {}, {}, 'cpu', time.time())".format(
            cell, seed, seconds, trace),
        "print(json.dumps(result))"])
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp,
                          capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(done.stderr[-4000:])
    return json.loads(done.stdout.strip().splitlines()[-1])
