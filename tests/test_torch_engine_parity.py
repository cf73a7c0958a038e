"""The port's dataset engine against the JAX package's, on the CPU, in one
process (a set's iteration order follows the process's string hashes, so
two processes need not generate the same bytes).

The JAX engine draws from the module-level ``random`` and ``np.random``
after ``random.seed(s)`` and ``np.random.seed(s)``; the port's from
``random.Random(s)`` and ``np.random.RandomState(s)``, made by
``GroundedScan(seed=s)``. Held byte for byte: ``dataset.txt`` and every
``*_dataset_stats.txt`` (uniform with a dev set, generalization with
k-shot, target_lengths, a sampled nonce vocabulary) and the loader's
k-shot move; the command line's
``--mode=generate`` directory file for file (plots: SVG in the port, PNG
in JAX, compared by what each plot function was given; renders and GIFs
by their pixels); the GECA-augmented file; and ``read_gscan``'s arrays.
"""

import json
import os
import random

import numpy as np
import pytest

from multimodal_seq2seq_gscan_tpu.cli import gscan as jax_cli
from multimodal_seq2seq_gscan_tpu.data import read_gscan as jax_read
from multimodal_seq2seq_gscan_tpu.gscan import GroundedScan as JaxScan
from multimodal_seq2seq_gscan_tpu.gscan.geca import GecaAugmenter as JaxGeca
from multimodal_seq2seq_gscan_tpu_torch.cli import gscan as port_cli
from multimodal_seq2seq_gscan_tpu_torch.data import read_gscan as port_read
from multimodal_seq2seq_gscan_tpu_torch.gscan import GroundedScan
from multimodal_seq2seq_gscan_tpu_torch.gscan.geca import GecaAugmenter

JAX_PLOTS = "multimodal_seq2seq_gscan_tpu.analysis.plots"
PORT_PLOTS = "multimodal_seq2seq_gscan_tpu_torch.analysis.plots"

ADVERB_WORDS = dict(
    intransitive_verbs=["walk"], transitive_verbs=["push", "pull"],
    adverbs=["cautiously", "while spinning", "hesitantly",
             "while zigzagging"],
    nouns=["circle", "square", "cylinder"],
    color_adjectives=["red", "green", "yellow", "blue"],
    size_adjectives=["big", "small"], sample_vocabulary="default",
    type_grammar="adverb")

# (name, seed, constructor keywords, get_data_pairs keywords), each at a
# small max_examples at which every split the test names is non-empty
# (the configurations of tests/test_splits.py and test_cli_and_analysis.py).
CASES = [
    ("uniform", 5, dict(
        intransitive_verbs=["walk"], transitive_verbs=["push"], adverbs=[],
        nouns=["circle", "square"], color_adjectives=["red", "green"],
        size_adjectives=["big", "small"], sample_vocabulary="default",
        type_grammar="normal", grid_size=6),
     dict(max_examples=300, split_type="uniform", make_dev_set=True)),
    ("generalization", 2, dict(ADVERB_WORDS, grid_size=4),
     dict(max_examples=4000, split_type="generalization", make_dev_set=True,
          k_shot_generalization=5)),
    ("target_lengths", 3, dict(
        intransitive_verbs=["walk"], transitive_verbs=["push"], adverbs=[],
        nouns=["circle", "square"], color_adjectives=["red", "green"],
        size_adjectives=["big", "small"], sample_vocabulary="default",
        type_grammar="normal", grid_size=6),
     dict(max_examples=600, split_type="target_lengths",
          cut_off_target_length=8)),
    ("nonce_vocabulary", 4, dict(
        intransitive_verbs=1, transitive_verbs=2, adverbs=1, nouns=3,
        color_adjectives=4, size_adjectives=2, sample_vocabulary="sample",
        type_grammar="adverb", grid_size=4),
     dict(max_examples=200, split_type="uniform")),
]


class PlotCalls:
    """Stands in for a plot function: records what it is given, and calls
    ``function`` with it, if one is given."""

    def __init__(self, function=None):
        self.calls = []
        self.function = function

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        if self.function is not None:
            self.function(*args, **kwargs)

    def normalised(self):
        """Every call's arguments in order, the path as its file stem."""
        out = []
        for args, kwargs in self.calls:
            values, title, path = args[:3]
            out.append((list(values.items()), title,
                        os.path.splitext(os.path.basename(path))[0],
                        kwargs.get("errors"), kwargs.get("y_axis_label")))
        return out


def generate_both(tmp_path, seed, constructor, pairs, monkeypatch):
    """Each package generates into its own directory and writes the dataset
    and the statistics of every split with examples; returns the two
    directories and each package's recorded bar_plot calls."""
    directories, plot_calls = [], []
    for package, cls in (("jax", JaxScan), ("port", GroundedScan)):
        directory = str(tmp_path / package)
        os.makedirs(directory)
        calls = PlotCalls()
        monkeypatch.setattr(
            (JAX_PLOTS if package == "jax" else PORT_PLOTS) + ".bar_plot",
            calls)
        if package == "jax":
            random.seed(seed)
            np.random.seed(seed)
            dataset = cls(percentage_train=0.8, min_object_size=1,
                          max_object_size=4, save_directory=directory,
                          **constructor)
        else:
            dataset = cls(percentage_train=0.8, min_object_size=1,
                          max_object_size=4, save_directory=directory,
                          seed=seed, **constructor)
        dataset.get_data_pairs(num_resampling=1, **pairs)
        for split, examples in dataset._data_pairs.items():
            if examples:
                dataset.save_dataset_statistics(split=split)
        dataset.save_dataset("dataset.txt")
        directories.append(directory)
        plot_calls.append(calls.normalised())
    return directories, plot_calls


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name,seed,constructor,pairs", CASES,
                         ids=[case[0] for case in CASES])
def test_generation_is_byte_equal(name, seed, constructor, pairs, tmp_path,
                                  monkeypatch):
    (jax_dir, port_dir), (jax_plots, port_plots) = generate_both(
        tmp_path, seed, constructor, pairs, monkeypatch)
    with open(os.path.join(port_dir, "dataset.txt")) as f:
        examples = json.load(f)["examples"]
    wanted = {"uniform": ("train", "dev", "test"),
              "generalization": ("train", "dev", "test", "adverb_1"),
              "target_lengths": ("train", "test"),
              "nonce_vocabulary": ("train", "test")}[name]
    for split in wanted:
        assert examples[split], split
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(port_dir))
    stats = [n for n in names if n.endswith("_dataset_stats.txt")]
    assert len(stats) >= len(wanted)
    for file_name in ["dataset.txt"] + stats:
        assert read_bytes(os.path.join(jax_dir, file_name)) == read_bytes(
            os.path.join(port_dir, file_name)), file_name
    assert jax_plots and port_plots == jax_plots
    if name == "generalization":
        # The loader's k-shot move (adverb_1 examples to train and dev),
        # drawn from the global random in JAX and from seed= in the port.
        path = os.path.join(port_dir, "dataset.txt")
        random.seed(11)
        jax_loaded = JaxScan.load_dataset_from_file(path, jax_dir, k=5)
        port_loaded = GroundedScan.load_dataset_from_file(path, port_dir,
                                                          k=5, seed=11)
        assert port_loaded._data_pairs == jax_loaded._data_pairs
        assert len(port_loaded._data_pairs["train"]) == \
            len(examples["train"]) + 5


def _gscan_flags(cli, **overrides):
    flags = {a.dest: a.default for a in cli.build_parser()._actions
             if a.dest != "help"}
    flags.update(overrides)
    return flags


def _tree(directory):
    return sorted(os.path.relpath(os.path.join(root, name), directory)
                  for root, _, names in os.walk(directory) for name in names)


def test_cli_generate_directories_match(tmp_path, monkeypatch):
    """--mode=generate (tests/test_cli_and_analysis.py's flags, seed 5):
    the same files; texts byte for byte; every render's pixels and every
    GIF frame equal (decoded by PIL); each plot given the same values,
    title, errors and label by both packages, at the same file stem (PNG
    in JAX, SVG in the port)."""
    from PIL import Image

    from multimodal_seq2seq_gscan_tpu.analysis import plots as jax_plots
    from multimodal_seq2seq_gscan_tpu_torch.analysis import plots

    recorded = {}
    for name, cli, module in (("jax", jax_cli, jax_plots),
                              ("port", port_cli, plots)):
        calls = PlotCalls(module.bar_plot)
        monkeypatch.setattr(module, "bar_plot", calls)
        directory = str(tmp_path / name)
        flags = dict(
            mode="generate", output_directory=directory, split="uniform",
            grid_size=6, num_resampling=1, max_examples=300,
            intransitive_verbs="walk", transitive_verbs="push", adverbs="",
            nouns="circle,square", color_adjectives="red,green",
            size_adjectives="big,small", type_grammar="normal",
            make_dev_set=True, visualize_per_template=1, seed=5)
        cli.main(_gscan_flags(cli, **flags))
        recorded[name] = calls.normalised()
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_files, port_files = _tree(jax_dir), _tree(port_dir)
    jax_plot_files = [f for f in jax_files
                      if os.sep not in f and f.endswith(".png")]
    assert jax_plot_files
    assert [f for f in port_files if f.endswith(".svg")] == sorted(
        f[:-4] + ".svg" for f in jax_plot_files)
    rest = [f for f in jax_files if f not in jax_plot_files]
    assert rest == [f for f in port_files if not f.endswith(".svg")]
    frames = 0
    for file_name in rest:
        jax_path = os.path.join(jax_dir, file_name)
        port_path = os.path.join(port_dir, file_name)
        if file_name.endswith((".png", ".gif")):
            jax_image, port_image = Image.open(jax_path), Image.open(port_path)
            count = getattr(jax_image, "n_frames", 1)
            assert getattr(port_image, "n_frames", 1) == count, file_name
            for i in range(count):
                jax_image.seek(i)
                port_image.seek(i)
                assert np.array_equal(
                    np.asarray(jax_image.convert("RGB")),
                    np.asarray(port_image.convert("RGB"))), (file_name, i)
                frames += 1
        else:
            assert read_bytes(jax_path) == read_bytes(port_path), file_name
    assert frames > 0
    assert recorded["jax"] and recorded["port"] == recorded["jax"]


def test_geca_augmentation_is_byte_equal(tmp_path):
    """The same generated dataset, augmented by each package with
    random.Random(3): the same additions and the same saved file."""
    constructor = dict(ADVERB_WORDS, grid_size=6,
                       transitive_verbs=["push"],
                       adverbs=["cautiously", "while spinning"],
                       nouns=["circle", "square"],
                       color_adjectives=["red", "green"])
    datasets = []
    for name, cls in (("jax", JaxScan), ("port", GroundedScan)):
        directory = str(tmp_path / name)
        os.makedirs(directory)
        if name == "jax":
            random.seed(5)
            np.random.seed(5)
            dataset = cls(percentage_train=0.8, min_object_size=1,
                          max_object_size=4, save_directory=directory,
                          **constructor)
        else:
            dataset = cls(percentage_train=0.8, min_object_size=1,
                          max_object_size=4, save_directory=directory,
                          seed=5, **constructor)
        dataset.get_data_pairs(max_examples=300, num_resampling=1,
                               split_type="uniform", make_dev_set=True)
        datasets.append(dataset)
    jax_dataset, port_dataset = datasets
    before = port_dataset.num_examples("train")
    assert jax_dataset._data_pairs == port_dataset._data_pairs
    jax_added = JaxGeca(jax_dataset).augment(40, random.Random(3))
    port_added = GecaAugmenter(port_dataset).augment(40, random.Random(3))
    assert port_added == jax_added > 0
    assert port_dataset._data_pairs["train"][before:] == \
        jax_dataset._data_pairs["train"][before:]
    assert port_dataset._template_identifiers == \
        jax_dataset._template_identifiers
    paths = [d.save_dataset("geca.txt") for d in datasets]
    assert read_bytes(paths[0]) == read_bytes(paths[1])


def test_read_gscan_matches_jax(tmp_path):
    dataset = GroundedScan(percentage_train=0.8, min_object_size=1,
                           max_object_size=4, save_directory=str(tmp_path),
                           seed=6, **dict(ADVERB_WORDS, grid_size=5))
    dataset.get_data_pairs(max_examples=150, num_resampling=1,
                           split_type="uniform", make_dev_set=True)
    path = dataset.save_dataset("dataset.txt")
    jax_data, port_data = jax_read.data_loader(path), \
        port_read.data_loader(path)
    assert list(port_data) == list(jax_data)
    assert sum(len(v) for v in port_data.values()) > 100
    for split in jax_data:
        assert port_data[split] == jax_data[split]
    example = port_data["train"][0]
    assert np.asarray(example["situation"]).shape[:2] == (5, 5)
