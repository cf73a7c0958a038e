"""Read-only checkpoint loading (the JAX package's ``train/checkpoint.py``).

The JAX trainer writes its TrainState with flax's msgpack serializer: a map
``step/params/opt_state/rng`` whose leaves are ndarray ext records. Only
``params`` is read here, through ``utils/msgpack_lite`` (no flax, no msgpack).
"""

import os
from typing import Union

import torch

from multimodal_seq2seq_gscan_tpu_torch.models.params import (
    ModelParams, params_from_numpy)
from multimodal_seq2seq_gscan_tpu_torch.utils import msgpack_lite


def read_checkpoint(path: str) -> dict:
    """The whole checkpoint as nested dicts of numpy arrays."""
    if not os.path.isfile(path):
        raise FileNotFoundError("No checkpoint found at {}".format(path))
    with open(path, "rb") as f:
        state = msgpack_lite.unpackb(f.read())
    if not isinstance(state, dict) or "params" not in state:
        raise ValueError("{} holds no 'params' map".format(path))
    return state


def load_params(path: str, device: Union[str, torch.device] = "cuda"
                ) -> ModelParams:
    """The model parameters of a JAX-trained checkpoint, on ``device``."""
    return params_from_numpy(read_checkpoint(path)["params"], device=device)
