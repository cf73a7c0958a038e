"""The port's oracle, world and analysis tools against the JAX package's, on
the CPU.

- The oracle: ``demonstrate_command`` on the first 256 dev examples of the
  trained fixture (``data/bench_fixture/dataset.txt``) gives, in both
  packages, the stored ``target_commands``; the world's dense grid equals
  the port's ``encode_situation_from_representation``.
- The analysis: one ``predict.json`` written by the port's
  ``predict_and_save`` from a small random-init model on 16 examples of a
  generated dataset, half of its records then made exact matches (target
  copied into prediction) so that both branches of the tools run. Held
  byte for byte: ``error_analysis.txt``, its ``.xls`` and
  ``position_analysis.xls``; the plots by what each package's plot
  functions were given; ``--mode=execute_commands``'s folders and file
  names, with every frame's pixels.
- The renderer: JAX's shapes with and without attention; grid lines,
  shading and squares pixel-exact; over a seeded sweep (every shape, sizes
  1 to 4, four headings) at most 1% of an image's pixels differ, each on
  the rim of a circle, a cylinder or the agent (the share is printed).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from multimodal_seq2seq_gscan_tpu.analysis import error_analysis as jax_ea
from multimodal_seq2seq_gscan_tpu.analysis import render as jax_render
from multimodal_seq2seq_gscan_tpu.cli import gscan as jax_cli
from multimodal_seq2seq_gscan_tpu.gscan import GroundedScan as JaxScan
from multimodal_seq2seq_gscan_tpu.gscan import types as jax_types
from multimodal_seq2seq_gscan_tpu_torch.analysis import error_analysis
from multimodal_seq2seq_gscan_tpu_torch.analysis import render
from multimodal_seq2seq_gscan_tpu_torch.cli import gscan as port_cli
from multimodal_seq2seq_gscan_tpu_torch.gscan import GroundedScan
from multimodal_seq2seq_gscan_tpu_torch.gscan import types
from multimodal_seq2seq_gscan_tpu_torch.gscan.encode import (
    encode_situation_from_representation)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURE = os.path.join(ROOT, "data", "bench_fixture", "dataset.txt")
N_ORACLE = 256
N_PREDICT = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's torch work (six xdist workers
    share the host's cores); restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_oracle_replays_fixture_as_jax(tmp_path):
    with open(FIXTURE) as f:
        dev = json.load(f)["examples"]["dev"][:N_ORACLE]
    jax_scan = JaxScan.load_dataset_header(FIXTURE, str(tmp_path))
    port_scan = GroundedScan.load_dataset_header(FIXTURE, str(tmp_path))
    grid_size = port_scan._world.grid_size
    for example in dev:
        stored = example["target_commands"].split(",")
        actions = []
        for scan, situation_cls in ((jax_scan, jax_types.Situation),
                                    (port_scan, types.Situation)):
            derivation = scan.parse_derivation_repr(example["derivation"])
            situation = situation_cls.from_representation(
                example["situation"])
            commands, _, _ = scan.demonstrate_command(derivation, situation)
            actions.append(commands)
        assert actions[1] == actions[0] == stored
        port_scan.initialize_world(
            types.Situation.from_representation(example["situation"]))
        jax_scan.initialize_world(
            jax_types.Situation.from_representation(example["situation"]))
        grid = port_scan._world.get_current_situation_grid_repr()
        encoded = encode_situation_from_representation(
            example["situation"], grid_size)
        assert np.array_equal(grid, encoded)
        assert np.array_equal(
            jax_scan._world.get_current_situation_grid_repr(), grid)


# ---------------------------------------------------------------------------
# Analysis of a predict.json
# ---------------------------------------------------------------------------

def _flags(cli, **overrides):
    flags = {a.dest: a.default for a in cli.build_parser()._actions
             if a.dest != "help"}
    flags.update(overrides)
    return flags


@pytest.fixture(scope="module")
def predictions(tmp_path_factory):
    """(dataset.txt path, one output directory per package, each holding
    the same predict.json)."""
    from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
        GroundedScanDataset)
    from multimodal_seq2seq_gscan_tpu_torch.decode.predict import (
        predict_and_save)
    from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
    from multimodal_seq2seq_gscan_tpu_torch.models.params import (
        init_model_params)

    directory = str(tmp_path_factory.mktemp("analysis_parity"))
    scan = GroundedScan(
        intransitive_verbs=["walk"], transitive_verbs=["push", "pull"],
        adverbs=["cautiously", "while spinning", "hesitantly",
                 "while zigzagging"],
        nouns=["circle", "square", "cylinder"],
        color_adjectives=["red", "green", "yellow", "blue"],
        size_adjectives=["big", "small"], percentage_train=0.8,
        min_object_size=1, max_object_size=4, sample_vocabulary="default",
        save_directory=directory, grid_size=5, type_grammar="adverb", seed=7)
    scan.get_data_pairs(max_examples=400, num_resampling=1,
                        split_type="uniform")
    path = scan.save_dataset("dataset.txt")
    dataset = GroundedScanDataset(path, directory, split="test",
                                  generate_vocabulary=True, backend="engine")
    dataset.read_dataset(max_examples=N_PREDICT)
    config = ModelConfig(
        input_vocabulary_size=dataset.input_vocabulary_size,
        target_vocabulary_size=dataset.target_vocabulary_size,
        num_cnn_channels=dataset.image_channels, embedding_dimension=8,
        encoder_hidden_size=16, decoder_hidden_size=16, cnn_kernel_size=3,
        cnn_hidden_num_channels=8,
        input_padding_idx=dataset.input_vocabulary.pad_idx,
        target_pad_idx=dataset.target_vocabulary.pad_idx,
        target_sos_idx=dataset.target_vocabulary.sos_idx,
        target_eos_idx=dataset.target_vocabulary.eos_idx)
    params = init_model_params(config, torch.Generator().manual_seed(3),
                               "cpu")
    predict_path = os.path.join(directory, "predict.json")
    predict_and_save(dataset, params, config, predict_path,
                     max_decoding_steps=12, batch_size=N_PREDICT,
                     device="cpu")
    with open(predict_path) as f:
        records = json.load(f)
    assert len(records) == N_PREDICT
    for record in records[::2]:
        steps = record["attention_weights_situation"]
        record["prediction"] = list(record["target"])
        record["attention_weights_situation"] = (
            steps + [steps[-1]] * (len(record["target"]) + 1 - len(steps)))
        record["accuracy"] = 100.0
        record["exact_match"] = True
    assert not any(r["exact_match"] for r in records[1::2])
    outputs = {}
    for name in ("jax", "port"):
        outputs[name] = os.path.join(directory, name)
        os.makedirs(outputs[name])
        with open(os.path.join(outputs[name], "predict.json"), "w") as f:
            json.dump(records, f, indent=4)
    return path, outputs


def _read(path):
    with open(path, "rb") as f:
        return f.read()


class PlotCalls:
    def __init__(self, function=None):
        self.function, self.calls = function, []

    def __call__(self, *args, **kwargs):
        bound = dict(zip(("values", "title", "save_path"), args), **kwargs)
        values = bound.pop("values")
        path = bound.pop("save_path")
        self.calls.append((list(values.items()),
                           os.path.splitext(os.path.basename(path))[0],
                           sorted(bound.items(), key=lambda kv: kv[0])))
        if self.function is not None:
            self.function(*args, **kwargs)


def test_error_analysis_matches_jax(predictions, monkeypatch):
    path, outputs = predictions
    calls = {}
    for name, cli, module in (("jax", jax_cli, jax_ea),
                              ("port", port_cli, error_analysis)):
        draw = name == "port"
        calls[name] = (PlotCalls(module.bar_plot if draw else None),
                       PlotCalls(module.grouped_bar_plot if draw else None))
        monkeypatch.setattr(module, "bar_plot", calls[name][0])
        monkeypatch.setattr(module, "grouped_bar_plot", calls[name][1])
        cli.main(_flags(cli, mode="error_analysis", load_dataset_from=path,
                        output_directory=outputs[name],
                        predicted_commands_files="predict.json"))
    jax_dir = os.path.join(outputs["jax"], "predict")
    port_dir = os.path.join(outputs["port"], "predict")
    for file_name in ("error_analysis.txt", "error_analysis.xls"):
        assert _read(os.path.join(jax_dir, file_name)) == _read(
            os.path.join(port_dir, file_name)), file_name
    text = _read(os.path.join(port_dir, "error_analysis.txt")).decode()
    assert "Num. exact matches: {}".format(N_PREDICT // 2) in text
    for jax_calls, port_calls in zip(calls["jax"], calls["port"]):
        assert jax_calls.calls and port_calls.calls == jax_calls.calls
    svgs = sorted(n for n in os.listdir(port_dir) if n.endswith(".svg"))
    assert svgs == sorted(c[1] + ".svg" for plot in calls["port"]
                          for c in plot.calls)


def test_position_analysis_matches_jax(predictions):
    path, outputs = predictions
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        cli.main(_flags(cli, mode="position_analysis", load_dataset_from=path,
                        output_directory=outputs[name],
                        predicted_commands_files="predict.json"))
    jax_xls, port_xls = (os.path.join(outputs[n], "position_analysis.xls")
                         for n in ("jax", "port"))
    assert _read(port_xls)[:4] == b"\xd0\xcf\x11\xe0"
    assert _read(jax_xls) == _read(port_xls)


def test_visualize_prediction_matches_jax(predictions, tmp_path):
    """--mode=execute_commands: the same folders and files; each PNG's and
    each GIF frame's pixels equal (decoded by PIL)."""
    from PIL import Image

    path, outputs = predictions
    trees = {}
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        out = str(tmp_path / name)
        os.makedirs(out)
        shutil.copy(os.path.join(outputs[name], "predict.json"), out)
        cli.main(_flags(cli, mode="execute_commands", load_dataset_from=path,
                        output_directory=out,
                        predicted_commands_files="predict.json"))
        os.remove(os.path.join(out, "predict.json"))
        trees[name] = (out, sorted(
            os.path.relpath(os.path.join(root, f), out)
            for root, _, files in os.walk(out) for f in files))
    (jax_out, jax_files), (port_out, port_files) = trees["jax"], \
        trees["port"]
    assert port_files == jax_files
    assert any(f.startswith("errors" + os.sep) for f in port_files)
    assert any(f.startswith("exact_matches" + os.sep) for f in port_files)
    for file_name in jax_files:
        jax_image = Image.open(os.path.join(jax_out, file_name))
        port_image = Image.open(os.path.join(port_out, file_name))
        count = getattr(jax_image, "n_frames", 1)
        assert getattr(port_image, "n_frames", 1) == count
        for i in range(count):
            jax_image.seek(i)
            port_image.seek(i)
            assert np.array_equal(np.asarray(jax_image.convert("RGB")),
                                  np.asarray(port_image.convert("RGB")))


def test_visualize_prediction_cap(predictions, tmp_path):
    """The port's ``max_visualized`` stops after that many folders."""
    path, outputs = predictions
    scan = GroundedScan.load_dataset_header(path, str(tmp_path))
    folders = scan.visualize_prediction(
        os.path.join(outputs["port"], "predict.json"), only_save_errors=True,
        max_visualized=3)
    assert len(folders) == 3
    assert all(os.sep + "errors" + os.sep in f for f in folders)


# ---------------------------------------------------------------------------
# The renderer
# ---------------------------------------------------------------------------

SHAPES = ("circle", "square", "cylinder")
COLORS = ("red", "green", "blue", "yellow")


def _situations(module, grid, objects, agent, heading):
    return module.Situation(
        grid_size=grid,
        agent_position=module.Position(row=agent[0], column=agent[1]),
        agent_direction=module.INT_TO_DIR[heading], target_object=None,
        placed_objects=[module.PositionedObject(
            object=module.Object(size=size, color=color, shape=shape),
            position=module.Position(row=row, column=column),
            vector=np.zeros(3)) for size, color, shape, row, column in
            objects], carrying=None)


def _both(grid, objects, agent, heading, attention=None):
    return (jax_render.render_situation(
        _situations(jax_types, grid, objects, agent, heading), attention),
        render.render_situation(
            _situations(types, grid, objects, agent, heading), attention))


def _rims(grid, objects, agent, heading):
    """Pixels within one pixel of the outline of a circle, a cylinder or
    the agent, by the port's masks."""
    size_px = grid * render.CELL_PIXELS
    rims = np.zeros((size_px, size_px), dtype=bool)
    specs = [(render._shape_mask(shape, size), column, row)
             for size, _, shape, row, column in objects
             if shape != "square"]
    specs.append((render._agent_mask(agent[1], agent[0], heading), 0, 0))
    for (x_off, y_off, mask), column, row in specs:
        padded = np.pad(mask, 2)
        inside = padded[1:-1, 1:-1]
        edge = np.zeros_like(inside)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                edge |= padded[1 + dy:padded.shape[0] - 1 + dy,
                               1 + dx:padded.shape[1] - 1 + dx] != inside
        y0 = row * render.CELL_PIXELS + y_off - 1
        x0 = column * render.CELL_PIXELS + x_off - 1
        ys, xs = np.nonzero(edge)
        ys, xs = ys + y0, xs + x0
        keep = (ys >= 0) & (xs >= 0) & (ys < size_px) & (xs < size_px)
        rims[ys[keep], xs[keep]] = True
    return rims


def test_render_shapes_lines_shading_and_squares_match_jax():
    """Shapes of the arrays with and without attention; with squares only
    (and the agent, off its rim), every pixel equal."""
    rng = np.random.RandomState(0)
    for grid in (4, 6, 9):
        objects = [(int(rng.randint(1, 5)), COLORS[rng.randint(4)],
                    "square", int(rng.randint(grid)), int(rng.randint(grid)))
                   for _ in range(grid)]
        agent, heading = (int(rng.randint(grid)), int(rng.randint(grid))), 2
        attention = rng.dirichlet(np.ones(grid * grid))
        for weights in (None, attention):
            jax_image, port_image = _both(grid, objects, agent, heading,
                                          weights)
            assert port_image.shape == jax_image.shape == (
                grid * 60, grid * 60, 3)
            assert port_image.dtype == np.uint8
            off_rim = ~_rims(grid, [], agent, heading)
            assert np.array_equal(port_image[off_rim], jax_image[off_rim])


def test_render_sweep_differs_only_on_rims(capsys):
    """Every shape at sizes 1 to 4 in every colour, the agent in four
    headings, with and without attention, on a 6x6 grid: the share of
    differing pixels, at most 1% of each image and only on rims."""
    rng = np.random.RandomState(1)
    grid = 6
    differing = total = 0
    worst = 0.0
    for shape in SHAPES:
        for size in range(1, 5):
            for heading in range(4):
                cells = rng.permutation(grid * grid)[:5]
                objects = [(size, COLORS[i % 4], shape, int(c) // grid,
                            int(c) % grid) for i, c in enumerate(cells[:4])]
                agent = (int(cells[4]) // grid, int(cells[4]) % grid)
                for weights in (None, rng.dirichlet(np.ones(grid * grid))):
                    jax_image, port_image = _both(grid, objects, agent,
                                                  heading, weights)
                    assert port_image.shape == jax_image.shape
                    diff = (port_image != jax_image).any(axis=-1)
                    assert not (diff & ~_rims(grid, objects, agent,
                                              heading)).any()
                    worst = max(worst, diff.mean())
                    differing += int(diff.sum())
                    total += diff.size
    with capsys.disabled():
        print("\nrender sweep: {} of {} pixels differ from JAX ({:.6%}); "
              "worst image {:.6%}".format(differing, total,
                                          differing / total, worst))
    assert worst <= 0.01
