"""The port reads JAX checkpoints without flax or msgpack.

``utils/msgpack_lite`` must decode data/bench_fixture/model_best.msgpack to
exactly what ``flax.serialization.msgpack_restore`` gives (bit-equal leaves),
and must decode the msgpack types flax can emit as the ``msgpack`` package
wrote them.
"""

import os

import flax.serialization
import jax
import msgpack
import numpy as np
import pytest
import torch

from multimodal_seq2seq_gscan_tpu.models import count_parameters as jax_count
from multimodal_seq2seq_gscan_tpu_torch.models.params import count_parameters
from multimodal_seq2seq_gscan_tpu_torch.train.checkpoint import (
    load_params, read_checkpoint)
from multimodal_seq2seq_gscan_tpu_torch.utils import msgpack_lite

CHECKPOINT = os.path.join(os.path.dirname(__file__), "..", "data",
                          "bench_fixture", "model_best.msgpack")


def flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(flatten(value, "{}/{}".format(prefix, key)))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def both():
    with open(CHECKPOINT, "rb") as f:
        raw = f.read()
    return msgpack_lite.unpackb(raw), flax.serialization.msgpack_restore(raw)


def test_param_leaves_bit_equal_to_flax(both):
    port, ref = (flatten(tree["params"]) for tree in both)
    assert len(ref) == 32
    assert sorted(port) == sorted(ref)
    for name, array in ref.items():
        assert port[name].dtype == array.dtype, name
        assert port[name].shape == array.shape, name
        assert port[name].tobytes() == array.tobytes(), name


def test_whole_state_equal_to_flax(both):
    """step, rng and the Adam state decode too (ints, uint32 keys)."""
    port, ref = (flatten(tree) for tree in both)
    assert sorted(port) == sorted(ref)
    for name, value in ref.items():
        np.testing.assert_array_equal(np.asarray(port[name]),
                                      np.asarray(value), err_msg=name)
    assert int(port["/step"]) == 200000


def test_loaded_params_count_and_values(both):
    params = load_params(CHECKPOINT, device="cpu")
    ref = both[1]["params"]
    leaves = jax.tree.leaves(ref)
    assert count_parameters(params) == jax_count(ref) \
        == sum(leaf.size for leaf in leaves)
    np.testing.assert_array_equal(
        params.decoder.lstm_layers[0].w_ih.numpy(),
        ref["decoder"]["lstm_layers"]["0"]["w_ih"])
    np.testing.assert_array_equal(params.cnn.convk_w.numpy(),
                                  ref["cnn"]["convk_w"])
    assert params.encoder.fwd_layers[0].w_hh.dtype == torch.float32


def _ndarray_ext(array):
    payload = msgpack.packb((array.shape, array.dtype.name, array.tobytes()))
    return msgpack.ExtType(1, payload)


def test_decodes_msgpack_type_variety():
    value = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 40,
                 -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1,
                 -2 ** 40],
        "floats": [0.5, -1.25e-30, 3.0e300],
        "strings": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "é"],
        "bin": [b"", b"\x00" * 300, b"\x01" * 70000],
        "flags": [True, False, None],
        "long_list": list(range(20)),
        "long_map": {str(i): i for i in range(20)},
        "arrays": [_ndarray_ext(np.arange(6, dtype=np.float32).reshape(2, 3)),
                   _ndarray_ext(np.array([1, 2], np.uint32)),
                   _ndarray_ext(np.float32(7.5).reshape(()))],
    }
    raw = msgpack.packb(value, use_bin_type=True)
    ours = msgpack_lite.unpackb(raw)
    ref = msgpack.unpackb(raw, raw=False, strict_map_key=False)
    for key in ("ints", "floats", "strings", "bin", "flags", "long_list",
                "long_map"):
        assert ours[key] == ref[key], key
    np.testing.assert_array_equal(ours["arrays"][0],
                                  np.arange(6, dtype=np.float32).reshape(2, 3))
    assert ours["arrays"][1].dtype == np.uint32
    assert ours["arrays"][2].shape == () and float(ours["arrays"][2]) == 7.5


def test_rejects_unknown_ext_and_truncation():
    with pytest.raises(msgpack_lite.MsgpackError):
        msgpack_lite.unpackb(msgpack.packb(msgpack.ExtType(5, b"x")))
    raw = msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(msgpack_lite.MsgpackError):
        msgpack_lite.unpackb(raw[:-1])
    with pytest.raises(msgpack_lite.MsgpackError):
        msgpack_lite.unpackb(raw + b"\x00")


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        read_checkpoint(str(tmp_path / "absent.msgpack"))
