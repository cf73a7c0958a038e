"""Full float32 for PyTorch's own products on the card.

The model is float32, as the JAX package runs it. PyTorch's defaults let
cuDNN run convolutions in TF32 (10-bit mantissa), and a caller may have let
matmuls do the same. The entry points that run PyTorch's products (the
training step's forward and backward, the teacher-forced eval forward and
the greedy decode) run under :func:`full_float32`, so their precision does
not depend on the process's flags.
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
