"""Start the ranks of a data-parallel run, one process each.

``launch(fn, n, *args, device=...)`` spawns ``n`` processes
(``torch.multiprocessing``), joins them in one process group over a file
store in a temporary directory, builds the mesh (``parallel/mesh.py``) and
runs ``fn(mesh, *args, **kwargs)`` on every rank; it returns rank 0's
result (moved to the CPU). A rank that raises ends the others and the
launch raises.

- ``device="cuda"``: one GPU a rank (rank r on ``cuda:r``), NCCL. More
  ranks than ``torch.cuda.device_count()`` raise ``ValueError``: the run
  is never moved to fewer ranks or to the CPU. ``share_device=True`` puts
  every rank on ``cuda:0`` over gloo (NCCL refuses two ranks on one
  device): what a machine with one card can show of several ranks.
- ``device="cpu"``: gloo, one torch thread a rank (the tests' setting).

``fn`` must be importable by name (spawned processes import it).
"""

import logging
import os
import tempfile
from typing import Callable, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from multimodal_seq2seq_gscan_tpu_torch.parallel.mesh import (
    make_mesh, tree_map)


def _rank(rank: int, world_size: int, backend: str, device_type: str,
          share_device: bool, store: str, result: str, log: tuple,
          fn: Callable, args: tuple, kwargs: dict):
    if rank == 0 and log[1] is not None:
        logging.basicConfig(level=log[0], format=log[1])
    if device_type == "cuda":
        device = torch.device("cuda", 0 if share_device else rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method="file://" + store,
                            world_size=world_size, rank=rank)
    try:
        out = fn(make_mesh(device=device), *args, **kwargs)
        if rank == 0:
            torch.save(tree_map(lambda x: x.cpu() if isinstance(
                x, torch.Tensor) else x, out), result)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n: int, *args,
           device: Union[str, torch.device] = "cuda",
           share_device: bool = False, **kwargs):
    """Run ``fn(mesh, *args, **kwargs)`` on ``n`` ranks; rank 0's result
    (see the module docstring)."""
    device = torch.device(device)
    if n < 1:
        raise ValueError("a launch needs at least one rank, got {}".format(n))
    backend = "gloo"
    if device.type == "cuda":
        available = torch.cuda.device_count()
        needed = 1 if share_device else n
        if available < needed:
            raise ValueError(
                "{} ranks need {} GPUs but only {} are available".format(
                    n, needed, available))
        if not share_device:
            backend = "nccl"
    elif device.type != "cpu":
        raise ValueError("launch runs on 'cuda' or 'cpu', not {!r}".format(
            device.type))
    root = logging.getLogger()
    log = (root.level, root.handlers[0].formatter._fmt
           if root.handlers and root.handlers[0].formatter else None)
    with tempfile.TemporaryDirectory(prefix="gscan_launch_") as scratch:
        store = os.path.join(scratch, "store")
        result = os.path.join(scratch, "result.pt")
        mp.start_processes(
            _rank, args=(n, backend, device.type, share_device, store,
                         result, log, fn, args, kwargs),
            nprocs=n, join=True, start_method="spawn")
        return torch.load(result, weights_only=False)
