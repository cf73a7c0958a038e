"""Checkpoints in the JAX package's format (``train/checkpoint.py`` there).

The JAX trainer writes its TrainState with flax's msgpack serializer: a map
``step/params/opt_state/rng`` whose leaves are ndarray ext records, where
``opt_state`` is ``{"0": {count, mu, nu}, "1": {count}}`` (optax's Adam and
schedule states). This module reads and writes that format through
``utils/msgpack_lite`` (no flax, no msgpack), so each package resumes from
the other's checkpoints, with the JSON sidecar of scalar bookkeeping and
the ``model_best`` copy on a better dev exact match.
"""

import json
import logging
import os
import shutil
from typing import Tuple, Union

import numpy as np
import torch

from multimodal_seq2seq_gscan_tpu_torch.models.params import (
    ModelParams, params_from_numpy, params_to_numpy)
from multimodal_seq2seq_gscan_tpu_torch.train.state import (
    TrainState, train_state_from_numpy)
from multimodal_seq2seq_gscan_tpu_torch.utils import msgpack_lite

logger = logging.getLogger(__name__)

CHECKPOINT_FILE = "checkpoint.msgpack"
BEST_CHECKPOINT_FILE = "model_best.msgpack"


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
    """The model parameters of a checkpoint, on ``device``."""
    return params_from_numpy(read_checkpoint(path)["params"], device=device)


def state_to_numpy(state: TrainState) -> dict:
    """The checkpoint map of a TrainState (flax's ``to_state_dict`` layout)."""
    opt = state.opt_state
    return {
        "step": np.asarray(state.step, np.int32),
        "params": params_to_numpy(state.params),
        "opt_state": {"0": {"count": np.asarray(opt.count, np.int32),
                            "mu": params_to_numpy(opt.mu),
                            "nu": params_to_numpy(opt.nu)},
                      "1": {"count": np.asarray(opt.schedule_count,
                                                np.int32)}},
        "rng": np.asarray(state.rng, np.uint32),
    }


def save_checkpoint(output_directory: str, state: TrainState, *,
                    is_best: bool = False, best_iteration: int = 0,
                    best_accuracy: float = 0.0, best_exact_match: float = 0.0,
                    file_name: str = CHECKPOINT_FILE) -> str:
    """Write the state and its JSON sidecar; copy both to ``model_best``
    when ``is_best``. Returns the checkpoint's path."""
    os.makedirs(output_directory, exist_ok=True)
    path = os.path.join(output_directory, file_name)
    with open(path, "wb") as f:
        f.write(msgpack_lite.packb(state_to_numpy(state)))
    meta = {
        "iteration": int(state.step),
        "best_iteration": int(best_iteration),
        "best_accuracy": float(best_accuracy),
        "best_exact_match": float(best_exact_match),
    }
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=4)
    if is_best:
        best_path = os.path.join(output_directory, BEST_CHECKPOINT_FILE)
        shutil.copyfile(path, best_path)
        shutil.copyfile(path + ".json", best_path + ".json")
    return path


def load_checkpoint(path: str, device: Union[str, torch.device] = "cuda"
                    ) -> Tuple[TrainState, dict]:
    """(TrainState on ``device``, meta); meta from the JSON sidecar, or
    defaults from the state's step when there is none."""
    state = train_state_from_numpy(read_checkpoint(path), device)
    meta_path = path + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    else:
        meta = {"iteration": state.step, "best_iteration": 0,
                "best_accuracy": 0.0, "best_exact_match": 0.0}
    logger.info("Loaded checkpoint '%s' (iter %d)", path, meta["iteration"])
    return state, meta
