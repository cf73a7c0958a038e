"""The port stands alone: no module of it, nor chip_smoke.py, imports jax,
flax, optax, msgpack, matplotlib, PIL or the JAX package (the card's
machine has none of them). Checked twice: statically, by scanning every
import statement, and dynamically, by importing every module in a fresh
interpreter where those names raise ImportError; there the dataset engine
also generates a dataset, draws its plots and renders, and analyses a
predict.json. Its C++ scanner names no file of the JAX package
nor its ``native/`` directory: the port builds its own copy."""

import ast
import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PACKAGE = "multimodal_seq2seq_gscan_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "matplotlib", "PIL",
           "multimodal_seq2seq_gscan_tpu")


def port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for directory, _, names in os.walk(os.path.join(ROOT, PACKAGE)):
        files += [os.path.join(directory, n) for n in names
                  if n.endswith(".py")]
    return sorted(files)


def imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_blocked_import_statements():
    files = port_files()
    assert len(files) > 15
    offenders = [(os.path.relpath(path, ROOT), root)
                 for path in files for root in imported_roots(path)
                 if root in BLOCKED]
    assert offenders == []


_BLOCK = r"""
import importlib, importlib.abc, json, pkgutil, sys
blocked = set(json.loads(sys.argv[1]))
for name in list(sys.modules):
    if name.split(".")[0] in blocked:
        del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in blocked:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Block())
"""

_IMPORT_ALL = _BLOCK + r"""
import multimodal_seq2seq_gscan_tpu_torch as package
names = [m.name for m in pkgutil.walk_packages(package.__path__,
                                               package.__name__ + ".")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
leaked = sorted(n for n in sys.modules if n.split(".")[0] in blocked)
print(json.dumps({"imported": len(names) + 1, "leaked": leaked,
                  "names": names}))
"""

# Modules that must be among those imported (the walk finds every module;
# these are named so that a missing one fails here).
REQUIRED = ("decode.predict", "train.resident", "utils.profiling",
            "train.loop", "ops.decode_block", "ops.teacher_forced",
            "cli.seq2seq", "data.prefetch", "models.torch_import",
            "utils.logging", "train.multiseed", "data.native_loader",
            "parallel.mesh", "parallel.launch", "parallel.dryrun",
            "gscan.types", "gscan.vocabulary", "gscan.object_vocabulary",
            "gscan.world", "gscan.grammar", "gscan.dataset", "gscan.geca",
            "analysis.workbook", "analysis.render", "analysis.plots",
            "analysis.visualize", "analysis.error_analysis",
            "analysis.position_analysis", "cli.gscan", "data.read_gscan")


def test_every_module_imports_with_blocked_packages():
    result = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL, json.dumps(BLOCKED)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
    report = json.loads(result.stdout.strip().splitlines()[-1])
    assert report["leaked"] == []
    assert report["imported"] > 15
    for name in REQUIRED:
        assert "{}.{}".format(PACKAGE, name) in report["names"], name


_ENGINE_RUN = _BLOCK + r"""
import json, os
from multimodal_seq2seq_gscan_tpu_torch.cli import gscan
out = sys.argv[2]

def run(**flags):
    values = {a.dest: a.default for a in gscan.build_parser()._actions
              if a.dest != "help"}
    values.update(flags, output_directory=out)
    gscan.main(values)

run(mode="generate", split="uniform", grid_size=4, num_resampling=1,
    max_examples=120, intransitive_verbs="walk", transitive_verbs="push",
    adverbs="cautiously", nouns="circle,square",
    color_adjectives="red,green", size_adjectives="big,small",
    type_grammar="adverb", visualize_per_template=1, seed=3)
dataset = os.path.join(out, "dataset.txt")
with open(dataset) as f:
    examples = json.load(f)["examples"]["test"][:6]
records = []
for i, example in enumerate(examples):
    target = example["target_commands"].split(",")
    prediction = target if i % 2 else target[:-1]
    steps = [[[1.0 / 16] * 16] for _ in range(len(prediction) + 1)]
    records.append({
        "input": example["command"].split(","), "prediction": prediction,
        "derivation": [example["derivation"]], "target": target,
        "situation": [example["situation"]],
        "attention_weights_input": [[1.0]], "attention_weights_situation": steps,
        "accuracy": 100.0 if i % 2 else 50.0, "exact_match": bool(i % 2),
        "position_accuracy": 100.0})
with open(os.path.join(out, "predict.json"), "w") as f:
    json.dump(records, f)
for mode in ("error_analysis", "position_analysis", "execute_commands"):
    run(mode=mode, load_dataset_from=dataset,
        predicted_commands_files="predict.json", max_visualized=2)
leaked = sorted(n for n in sys.modules if n.split(".")[0] in blocked)
print(json.dumps({"leaked": leaked, "files": sorted(
    os.path.relpath(os.path.join(root, name), out)
    for root, _, names in os.walk(out) for name in names)}))
"""


def test_engine_runs_with_blocked_packages(tmp_path):
    """--mode=generate, --mode=error_analysis, --mode=position_analysis and
    --mode=execute_commands in a fresh interpreter without matplotlib, PIL
    or JAX: statistics, SVG plots, PNG renders and GIFs, the .xls files."""
    result = subprocess.run(
        [sys.executable, "-c", _ENGINE_RUN, json.dumps(BLOCKED),
         str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
    report = json.loads(result.stdout.strip().splitlines()[-1])
    assert report["leaked"] == []
    files = report["files"]
    for name in ("dataset.txt", "train_dataset_stats.txt",
                 "train_verbs_in_command.svg", "predict/error_analysis.txt",
                 "predict/error_analysis.xls",
                 "predict/verb_in_command_accuracy.svg",
                 "position_analysis.xls"):
        assert name in files, name
    # max_visualized=2: the first record (an error) and the second (exact).
    movies = [f for f in files if f.endswith("/movie.gif")
              and f.split("/")[0] in ("errors", "exact_matches")]
    assert [m.split("/")[0] for m in movies] == ["errors", "exact_matches"]
    assert any(f.endswith("/movie.gif") and f not in movies
               for f in files)  # --mode=generate's visualizations
    for movie in movies:
        assert movie[:-len("movie.gif")] + "initial.png" in files
    assert not [f for f in files if f.endswith(".png") and "/" not in f]


def test_native_sources_are_the_ports_own():
    """The port's C++ sources name no path of the JAX package or of
    ``native/``, and the loader builds the port's copy. (The CUDA sources
    cite the Pallas kernels they replace.)"""
    from multimodal_seq2seq_gscan_tpu_torch.data import native_loader
    sources = [os.path.join(directory, n) for directory, _, names in
               os.walk(os.path.join(ROOT, PACKAGE)) for n in names
               if n.endswith(".cc")]
    assert [os.path.basename(path) for path in sources] == [
        "gscan_loader.cc"]
    assert str(native_loader.SOURCE) == os.path.join(
        os.path.realpath(ROOT), PACKAGE, "native", "gscan_loader.cc")
    for path in sources:
        with open(path) as f:
            text = f.read()
        for name in ("multimodal_seq2seq_gscan_tpu/", "native/gscan_loader",
                     "scripts/build_native", "data/_native"):
            assert name not in text, (os.path.relpath(path, ROOT), name)
