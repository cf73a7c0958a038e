"""Full float32 for PyTorch's own products on the card, and repeatable
training steps.

The model is float32, as the JAX package runs it. PyTorch's defaults let
cuDNN run convolutions in TF32 (10-bit mantissa), and a caller may have let
matmuls do the same. The entry points that run PyTorch's products (the
training step's forward and backward, the teacher-forced eval forward and
the greedy decode) run under :func:`full_float32`, so their precision does
not depend on the process's flags.

The training step's forward and backward also run under
:func:`deterministic_convolutions`: cuDNN's default algorithm for the CNN's
weight gradients adds with atomics, so two runs of one step from one state
differed in the last bits on an H100, and from a fresh initialisation
Adam carried that past 1e-6 within 20 steps. With
cuDNN's deterministic algorithms a step, its CUDA graph and every
capture of that graph give the same bits, which a resumed or multi-seed
run relies on to repeat a single run.
"""

import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    """Turn TF32 off for matmuls and cuDNN inside the block; restore the
    caller's flags after it. Usable as a decorator."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN's deterministic algorithms inside the block; restore the
    caller's flag after it. Usable as a decorator."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = deterministic
