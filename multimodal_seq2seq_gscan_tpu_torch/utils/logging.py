"""Parameter logging (the JAX package's ``utils/logging.py``; reference
seq2seq/helpers.py:35-41)."""

import logging
from typing import Iterator, Tuple

import torch

logger = logging.getLogger(__name__)


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor of a tree of NamedTuples and tuples,
    in field order, as JAX's ``tree_flatten_with_path`` names them
    (``encoder/fwd_layers/0/w_ih``); ``None`` leaves are skipped."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or [
            str(i) for i in range(len(tree))]
        for name, child in zip(names, tree):
            yield from named_leaves(
                child, "{}/{}".format(prefix, name) if prefix else name)


def log_parameters(params) -> int:
    """Log every parameter tensor's path and shape plus the total count."""
    total = 0
    for name, leaf in named_leaves(params):
        total += leaf.numel()
        logger.info("%s : %s", name, list(leaf.shape))
    logger.info("Total parameters: %d", total)
    return total
