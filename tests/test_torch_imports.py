"""The port stands alone: no module of it, nor chip_smoke.py, imports jax,
flax, optax, msgpack or the JAX package (the card's machine has none of
them). Checked twice: statically, by scanning every import statement, and
dynamically, by importing every module in a fresh interpreter where those
names raise ImportError. Its C++ scanner names no file of the JAX package
nor its ``native/`` directory: the port builds its own copy."""

import ast
import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PACKAGE = "multimodal_seq2seq_gscan_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack",
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


_IMPORT_ALL = r"""
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
            "utils.logging", "train.multiseed", "data.native_loader")


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
