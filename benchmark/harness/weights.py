"""The model's weights as the benchmark makes them: one named leaf list that
both sides take (the program through its own containers, the reference as
a dict), made on the device from the seed, or read from a checkpoint.

Leaf names and shapes are the JAX package's parameter tree, as the
checkpoint stores it ("encoder.fwd_layers.0.w_ih" and so on). A fresh
draw follows the port's initialisation
(``models/params.py::init_model_params`` at commit cacbdcd: PyTorch's
default uniform bounds, N(0, 1) embeddings with the pad row zeroed), drawn
as one uniform and one normal call on the device; the bits differ from the
port's own initialisation, which draws leaf by leaf on the host.
"""

import math
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from benchmark.harness.msgpack_reader import unpackb

PAD = 0


class Leaf(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    normal: bool   # N(0, 1) with the pad row zeroed, else U(-bound, bound)
    bound: float


def check_topology(cfg: dict):
    """The benchmark's reference models the flagship topology only."""
    wanted = dict(num_encoder_layers=1, num_decoder_layers=1,
                  encoder_bidirectional=True, conditional_attention=True,
                  auxiliary_task=False, attention_type="bahdanau")
    for key, value in wanted.items():
        if cfg[key] != value:
            raise ValueError("configuration {}: {} = {!r}; the benchmark's "
                             "reference takes {!r}".format(
                                 cfg["name"], key, cfg[key], value))


def layout(cfg: dict, input_vocabulary: int, target_vocabulary: int,
           channels: int) -> List[Leaf]:
    """Every leaf of the flagship model, in the port's leaf order."""
    check_topology(cfg)
    e, he = cfg["embedding_dimension"], cfg["encoder_hidden_size"]
    h, o, k = (cfg["decoder_hidden_size"], cfg["cnn_hidden_num_channels"],
               cfg["cnn_kernel_size"])
    leaves: List[Leaf] = []

    def uniform(name, shape, fan_in):
        leaves.append(Leaf(name, shape, False, 1.0 / math.sqrt(fan_in)))

    for name, size in (("conv1", 1), ("conv5", 5), ("convk", k)):
        uniform("cnn.{}_w".format(name), (size, size, channels, o),
                channels * size * size)
        uniform("cnn.{}_b".format(name), (o,), channels * size * size)

    def lstm(prefix, inputs, hidden):
        for name, shape in (("w_ih", (4 * hidden, inputs)),
                            ("w_hh", (4 * hidden, hidden)),
                            ("b_ih", (4 * hidden,)), ("b_hh", (4 * hidden,))):
            uniform("{}.{}".format(prefix, name), shape, hidden)

    leaves.append(Leaf("encoder.embedding", (input_vocabulary, e), True, 0.0))
    lstm("encoder.fwd_layers.0", e, he)
    lstm("encoder.bwd_layers.0", e, he)
    uniform("enc_to_dec_w", (he, h), he)
    uniform("enc_to_dec_b", (h,), he)
    for name, keys in (("textual_attention", he),
                       ("visual_attention", 3 * o)):
        uniform(name + ".key_w", (keys, h), keys)
        uniform(name + ".query_w", (h, h), h)
        uniform(name + ".energy_w", (h, 1), h)
    leaves.append(Leaf("decoder.embedding", (target_vocabulary, h), True,
                       0.0))
    lstm("decoder.lstm_layers.0", 3 * h, h)
    uniform("decoder.queries_to_keys_w", (2 * h, h), 2 * h)
    uniform("decoder.queries_to_keys_b", (h,), 2 * h)
    uniform("decoder.output_to_hidden_w", (4 * h, h), 4 * h)
    uniform("decoder.hidden_to_output_w", (h, target_vocabulary), h)
    return leaves


def generate(leaves: List[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """Fresh float32 weights from ``seed``, drawn on ``device`` in two
    calls (all uniform leaves, then all normal ones)."""
    generator = torch.Generator(device=device).manual_seed(int(seed))
    sizes = {leaf.name: math.prod(leaf.shape) for leaf in leaves}
    uniform = torch.rand(sum(sizes[l.name] for l in leaves if not l.normal),
                         generator=generator, device=device)
    normal = torch.randn(sum(sizes[l.name] for l in leaves if l.normal),
                         generator=generator, device=device)
    out, offsets = {}, {False: 0, True: 0}
    for leaf in leaves:
        source = normal if leaf.normal else uniform
        start = offsets[leaf.normal]
        piece = source[start:start + sizes[leaf.name]].view(leaf.shape)
        offsets[leaf.normal] = start + sizes[leaf.name]
        if leaf.normal:
            piece = piece.clone()
            piece[PAD] = 0.0
        else:
            piece = (piece * 2.0 - 1.0) * leaf.bound
        out[leaf.name] = piece.contiguous()
    return out


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        name = prefix + str(key)
        if isinstance(value, dict):
            out.update(_flatten(value, name + "."))
        elif value is not None:
            out[name] = np.asarray(value, np.float32)
    return out


def read_checkpoint(path: Path) -> Dict[str, np.ndarray]:
    """The named parameters of a flax msgpack checkpoint, as host arrays."""
    with open(path, "rb") as f:
        state = unpackb(f.read())
    return _flatten(state["params"])


def from_arrays(leaves: List[Leaf], arrays: Dict[str, np.ndarray],
                device) -> Dict[str, torch.Tensor]:
    """The named leaves on ``device``, checked against the layout."""
    missing = [l.name for l in leaves if l.name not in arrays]
    wrong = [(l.name, arrays[l.name].shape, l.shape) for l in leaves
             if l.name in arrays and tuple(arrays[l.name].shape) != l.shape]
    if missing or wrong or len(arrays) != len(leaves):
        raise ValueError("checkpoint does not fit the configuration: missing "
                         "{}, shapes {}, extra {}".format(
                             missing, wrong,
                             sorted(set(arrays) - {l.name for l in leaves})))
    return {l.name: torch.from_numpy(arrays[l.name]).to(device)
            for l in leaves}


def key(seed: int) -> np.ndarray:
    """The training state's two-word key for a seed (high word, low word)."""
    return np.array([(int(seed) >> 32) & 0xFFFFFFFF, int(seed) & 0xFFFFFFFF],
                    np.uint32)
