"""Kernel 1: fused masked additive attention (forward).

Replaces the TPU kernel ``multimodal_seq2seq_gscan_tpu/ops/pallas_attention.py``
(``fused_additive_attention``). CUDA source: ``csrc/additive_attention.cu``,
whose per-row body (``csrc/attend.cuh``) kernel 2 shares.

On the H100 the function is bound by bytes: each projected key is read for
its score and again for the context, with a handful of flops in between. The
kernel keeps the ``[B, M, H]`` tanh intermediate in registers (one warp per
row, lanes over H), so only the keys, the query and the two outputs touch
device memory, and the second read of a row's keys comes from cache.

``additive_attention`` is the wrapper: the plain version for CPU tensors, the
kernel for CUDA tensors (or an error; it never falls back).
"""

from typing import Optional, Tuple

import torch

from multimodal_seq2seq_gscan_tpu_torch.ops import _build

MAX_KEYS = 64     # kMaxM in csrc/attend.cuh
MAX_HIDDEN = 128  # kMaxH in csrc/attend.cuh

launches = 0  # kernel launches, counted by the wrapper


def additive_attention_plain(projected_queries: torch.Tensor,
                             projected_keys: torch.Tensor,
                             mask: Optional[torch.Tensor],
                             energy_w: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the same function as the kernel.

    projected_queries [B, H], projected_keys [B, M, H] (also the values),
    mask [B, M] or None (all valid), energy_w [H, 1].
    Returns (context [B, H], weights [B, M]).
    """
    hidden = torch.tanh(projected_queries[:, None, :] + projected_keys)
    scores = (hidden @ energy_w)[..., 0]                           # [B, M]
    if mask is not None:
        # -1e9, not -inf: an all-masked row gets uniform weights, not NaN.
        scores = scores.masked_fill(~(mask > 0), -1e9)
    weights = torch.softmax(scores, dim=-1)
    context = torch.bmm(weights[:, None, :], projected_keys)[:, 0]
    return context, weights


def check_tensor(name: str, tensor: torch.Tensor, shape: tuple,
                 dtype: torch.dtype, device: torch.device):
    """Raise unless ``tensor`` is what a kernel takes: a contiguous tensor of
    ``shape`` and ``dtype`` on ``device``."""
    if tensor.device != device:
        raise ValueError("{} is on {}, expected {}".format(
            name, tensor.device, device))
    if tensor.dtype != dtype:
        raise TypeError("{} must be {}, got {}".format(name, dtype,
                                                       tensor.dtype))
    if tuple(tensor.shape) != shape:
        raise ValueError("{} must have shape {}, got {}".format(
            name, shape, tuple(tensor.shape)))
    if not tensor.is_contiguous():
        raise ValueError("{} must be contiguous".format(name))


def additive_attention(projected_queries: torch.Tensor,
                       projected_keys: torch.Tensor,
                       mask: Optional[torch.Tensor],
                       energy_w: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked additive attention: the kernel on CUDA, the plain version on CPU.

    Same arguments and results as :func:`additive_attention_plain`.
    """
    device = projected_keys.device
    if device.type == "cpu":
        return additive_attention_plain(projected_queries, projected_keys,
                                        mask, energy_w)
    if device.type != "cuda":
        raise ValueError("additive_attention runs on cpu or cuda, not "
                         "{}".format(device))
    batch, m, h = projected_keys.shape
    if not (0 < m <= MAX_KEYS and 0 < h <= MAX_HIDDEN):
        raise ValueError("additive_attention kernel takes M <= {} and "
                         "H <= {}, got M={} H={}".format(MAX_KEYS, MAX_HIDDEN,
                                                         m, h))
    tensors = [("projected_queries", projected_queries, (batch, h)),
               ("projected_keys", projected_keys, (batch, m, h)),
               ("energy_w", energy_w, (h, 1))]
    if mask is not None:
        tensors.append(("mask", mask, (batch, m)))
    for name, tensor, shape in tensors:
        check_tensor(name, tensor, shape, torch.float32, device)
    context = torch.empty((batch, h), device=device, dtype=torch.float32)
    weights = torch.empty((batch, m), device=device, dtype=torch.float32)
    if batch == 0:
        return context, weights
    lib = _build.library()
    code = lib.gscan_additive_attention(
        projected_queries.data_ptr(), projected_keys.data_ptr(),
        mask.data_ptr() if mask is not None else None, energy_w.data_ptr(),
        context.data_ptr(), weights.data_ptr(), batch, m, h,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(code, "gscan_additive_attention")
    global launches
    launches += 1
    return context, weights
