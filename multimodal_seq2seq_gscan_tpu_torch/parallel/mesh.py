"""A ('data', 'model') mesh over the ranks of torch.distributed's group.

The port of the JAX package's ``parallel/mesh.py``. The model is small
(~440k parameters), so the strategy is data parallelism: every rank holds
the whole state, takes its contiguous rows of each global batch, and sums
its gradients with the other data ranks'. A rank is one process on one
device (``parallel/launch.py`` starts them), so each rank runs the port's
kernels on its own rows. The 'model' axis replicates, as JAX's does:
nothing is sharded over it, so rank r holds data shard
``r // model_parallel``, and sums run over the ranks of r's model index
(its data group).

The collectives the port uses are here, one function each, on tensors
where they live: the backend is ``"nccl"`` on the card and ``"gloo"`` on
the CPU. Without a mesh (``mesh=None``) each is the identity.
"""

from typing import NamedTuple, Optional, Union

import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    """This rank's view of a ('data', 'model') mesh over the ranks of the
    default process group, rank = data index * model_parallel + model
    index."""

    # The ranks of this rank's model index (None: the default group).
    data_group: Optional[object]
    rank: int
    world_size: int
    data_parallel: int
    model_parallel: int
    device: torch.device
    backend: str

    @property
    def shape(self):
        return (self.data_parallel, self.model_parallel)

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallel

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(data_parallel: Optional[int] = None, model_parallel: int = 1,
              device: Union[str, torch.device, None] = None) -> Mesh:
    """The mesh over the ranks of the default process group,
    ``data_parallel`` (all ranks over ``model_parallel``) x
    ``model_parallel``. Raises ``ValueError`` when the shape does not cover
    the ranks exactly: a caller is never given a smaller mesh than it asked
    for. ``device`` defaults to the current CUDA device under NCCL, else
    the CPU. Every rank must call it (a model axis above 1 makes one group
    per model index)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel/launch.py starts the ranks)")
    n = dist.get_world_size()
    if data_parallel is None:
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError("mesh {}x{} requires {} ranks but got {}".format(
            data_parallel, model_parallel, data_parallel * model_parallel,
            n))
    rank = dist.get_rank()
    backend = str(dist.get_backend())
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    data_group = None
    if model_parallel > 1:
        for m in range(model_parallel):
            new = dist.new_group([d * model_parallel + m
                                  for d in range(data_parallel)])
            if rank % model_parallel == m:
                data_group = new
    return Mesh(data_group, rank, n, data_parallel, model_parallel,
                torch.device(device), backend)


def check_mesh(mesh):
    """``mesh`` itself; a ``TypeError`` for anything but None or a Mesh."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a parallel.mesh.Mesh (make_mesh), got "
                        "{}".format(type(mesh).__name__))
    return mesh


def shard_rows(mesh: Optional[Mesh], rows: int) -> slice:
    """This rank's rows of a global batch of ``rows``; a ``ValueError``
    naming the sizes when the data axis does not divide them."""
    if mesh is None:
        return slice(0, rows)
    if rows % mesh.data_parallel:
        raise ValueError(
            "a batch of {} rows does not split over the {} ranks of the "
            "data axis".format(rows, mesh.data_parallel))
    per_rank = rows // mesh.data_parallel
    return slice(mesh.data_index * per_rank,
                 (mesh.data_index + 1) * per_rank)


def tree_map(fn, tree):
    """``fn`` on every leaf of nested (named) tuples, lists and dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [tree_map(fn, x) for x in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree)


def shard_batch(mesh: Optional[Mesh], batch):
    """This rank's contiguous rows of a global batch: a tensor, an array,
    or a (named) tuple of them, each split on its leading axis."""
    return tree_map(lambda x: x[shard_rows(mesh, x.shape[0])], batch)


def replicate(mesh: Optional[Mesh], tree):
    """Every tensor of a (nested) tuple, e.g. a TrainState, broadcast from
    rank 0, in place; the other leaves as they are."""
    if mesh is None:
        return tree

    def broadcast(leaf):
        if isinstance(leaf, torch.Tensor):
            dist.broadcast(leaf, 0)
        return leaf

    return tree_map(broadcast, tree)


def all_reduce_sum(mesh: Optional[Mesh], tensor: torch.Tensor
                   ) -> torch.Tensor:
    """``tensor`` summed over the data group, in place."""
    if mesh is not None:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=mesh.data_group)
    return tensor


def all_true(mesh: Optional[Mesh], flags: torch.Tensor) -> bool:
    """Whether ``flags`` hold everywhere on every data rank: one host
    sync."""
    pending = (~flags).sum().to(torch.int32)
    return int(all_reduce_sum(mesh, pending)) == 0


def gather_rows(mesh: Optional[Mesh], tensor: torch.Tensor) -> torch.Tensor:
    """The data ranks' ``tensor``s joined on the leading axis, in data
    order, on every rank (an all-gather: every rank gets the global
    rows)."""
    if mesh is None:
        return tensor
    tensor = tensor.contiguous()
    parts = [torch.empty_like(tensor) for _ in range(mesh.data_parallel)]
    dist.all_gather(parts, tensor, group=mesh.data_group)
    return torch.cat(parts)


def shard_examples_for_process(num_examples: int,
                               process_index: Optional[int] = None,
                               process_count: Optional[int] = None) -> slice:
    """Example-index slice for this process (multi-host data loading): each
    process loads only its contiguous shard, and ``make_global_batch``
    joins the shards into one global batch. By default the process is this
    rank of the default group."""
    if process_index is None:
        process_index = dist.get_rank() if dist.is_initialized() else 0
    if process_count is None:
        process_count = (dist.get_world_size() if dist.is_initialized()
                         else 1)
    per_process = num_examples // process_count
    start = process_index * per_process
    return slice(start, start + per_process)


def make_global_batch(mesh: Mesh, local_batch):
    """This rank's shard, on its device, of the global batch that the
    processes' local rows make in rank order. With a model axis of 1 a
    rank's local rows are its shard; else the local rows are gathered
    and sharded. Raises ``ValueError`` if the ranks hold different
    numbers of rows."""
    local = tree_map(lambda x: torch.as_tensor(x).to(mesh.device),
                     local_batch)
    leading = local[0] if isinstance(local, tuple) else local
    count = torch.tensor([leading.shape[0]], dtype=torch.int64,
                         device=mesh.device)
    counts = [torch.empty_like(count) for _ in range(mesh.world_size)]
    dist.all_gather(counts, count)
    counts = [int(c) for c in counts]
    if len(set(counts)) != 1:
        raise ValueError("the processes hold {} rows: a global batch needs "
                         "equal shards".format(counts))
    if mesh.model_parallel == 1:
        return local

    def joined(x):
        parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    return shard_batch(mesh, tree_map(joined, local))
