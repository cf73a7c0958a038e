"""What the harness and the reference load: no JAX, no JAX package, and,
for the reference, nothing of the program either. Modules are compared
by their top-level name, taken whole."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.harness import core

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
PORT = "multimodal_seq2seq_gscan_tpu_torch"


def loaded_after(code: str) -> set:
    """Top-level names in sys.modules after running ``code`` in a fresh
    interpreter at the root of the repo."""
    done = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(done.stdout.split())


def test_the_guard_compares_whole_top_level_names():
    saved = dict(sys.modules)
    try:
        sys.modules["multimodal_seq2seq_gscan_tpu_torch_probe"] = object()
        sys.modules["jaxtyping_probe"] = object()
        assert core.banned_modules() == [] or all(
            m.split(".")[0] in core.BANNED for m in core.banned_modules())
        assert "multimodal_seq2seq_gscan_tpu_torch_probe" not in \
            core.banned_modules()
        sys.modules["multimodal_seq2seq_gscan_tpu.probe"] = object()
        sys.modules["jax.probe"] = object()
        assert {"multimodal_seq2seq_gscan_tpu.probe", "jax.probe"} <= set(
            core.banned_modules())
    finally:
        for name in list(sys.modules):
            if name not in saved:
                del sys.modules[name]


def test_the_harness_and_drivers_load_no_jax():
    code = "\n".join([
        "import importlib, pathlib",
        "import benchmark.harness.core, benchmark.harness.main",
        "import benchmark.drivers.train_resident",
        "import benchmark.drivers.greedy_decode",
        "for p in pathlib.Path('benchmark/metrics').glob('*.py'):",
        "    benchmark.harness.core._reader(p.stem)",
        # What the drivers import of the port once a run starts.
        "import multimodal_seq2seq_gscan_tpu_torch.train.resident",
        "import multimodal_seq2seq_gscan_tpu_torch.decode.greedy"])
    loaded = loaded_after(code)
    assert not loaded & set(core.BANNED), loaded & set(core.BANNED)
    assert PORT in loaded


def test_the_reference_loads_nothing_of_either_package():
    code = ("import benchmark.reference.model, benchmark.reference.train, "
            "benchmark.reference.decode")
    loaded = loaded_after(code)
    assert not loaded & (set(core.BANNED) | {PORT})


def test_the_reference_sources_import_only_torch_numpy_and_itself():
    allowed = {"torch", "numpy", "hashlib", "contextlib", "typing", "math",
               "benchmark"}
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in allowed, (path.name, name)
                if name.startswith("benchmark"):
                    assert name.startswith("benchmark.reference"), name
