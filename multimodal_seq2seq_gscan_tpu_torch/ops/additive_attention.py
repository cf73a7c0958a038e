"""Kernel 1: fused masked additive attention (forward, with a plain backward).

Replaces the TPU kernel ``multimodal_seq2seq_gscan_tpu/ops/pallas_attention.py``
(``fused_additive_attention``). CUDA source: ``csrc/additive_attention.cu``,
whose per-row body (``csrc/attend.cuh``) kernel 2 shares.

On the H100 the function is bound by bytes: each projected key element
takes a handful of flops. The kernel reads each key row from device memory
once, 16 bytes per lane: one warp per row computes the scores and the
context in the same pass by an online softmax (a running maximum and sum,
the context rescaled when the maximum grows), keeping the ``[B, M, H]``
tanh intermediate in registers, with many rows and keys in flight. Past
H = 1024 the query and context no longer fit a lane's registers, and a row
takes two passes over its keys instead (``attend_row_wide``).

``additive_attention`` is the wrapper: the plain version for CPU tensors, the
kernel for CUDA tensors, at any M and H. On the card, when a gradient is wanted, it runs as
:class:`AdditiveAttention`, whose backward is the plain PyTorch port of the
TPU kernel's analytic VJP (``_attention_bwd``; the TPU kernel has no
backward kernel of its own either), so gradients flow through the kernel.
Without one (the greedy decode) it launches the kernel directly: the call is
host-bound, and an autograd node costs host time for nothing.

The kernel comes in two forms, picked from the tensors' dtypes before any
launch: float32 throughout, and bf16 keys with float32 or bf16 queries,
energy vector and mask (the bf16 decode variants, ``decode/greedy.py``),
which reads half the key bytes and computes in float32. Both return float32
outputs, as the TPU kernel does whatever its inputs. Any other combination
raises; nothing is converted.
"""

from typing import Optional, Tuple

import torch

from multimodal_seq2seq_gscan_tpu_torch.ops import _build

launches = 0  # launches of the float32 form, counted by the wrapper
launches_bf16 = 0  # launches of the bf16 form


def additive_attention_plain(projected_queries: torch.Tensor,
                             projected_keys: torch.Tensor,
                             mask: Optional[torch.Tensor],
                             energy_w: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the same function as the kernel.

    projected_queries [B, H], projected_keys [B, M, H] (also the values),
    mask [B, M] or None (all valid), energy_w [H, 1]. bf16 inputs are
    widened to float32 first (the kernel's bf16 form computes in float32).
    Returns (context [B, H], weights [B, M]).
    """
    projected_queries, projected_keys, mask, energy_w = (
        t.float() if t is not None and t.dtype == torch.bfloat16 else t
        for t in (projected_queries, projected_keys, mask, energy_w))
    hidden = torch.tanh(projected_queries[:, None, :] + projected_keys)
    scores = (hidden @ energy_w)[..., 0]                           # [B, M]
    if mask is not None:
        # -1e9, not -inf: an all-masked row gets uniform weights, not NaN.
        scores = scores.masked_fill(~(mask > 0), -1e9)
    weights = torch.softmax(scores, dim=-1)
    context = torch.bmm(weights[:, None, :], projected_keys)[:, 0]
    return context, weights


def attention_vjp_plain(projected_queries: torch.Tensor,
                        projected_keys: torch.Tensor, weights: torch.Tensor,
                        energy_w: torch.Tensor, d_context: torch.Tensor,
                        d_weights: Optional[torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Analytic VJP of the attention (``_attention_bwd`` in the JAX
    package's ``ops/pallas_attention.py``), recomputing tanh.

    Returns (d_projected_queries [B, H], d_projected_keys [B, M, H],
    d_energy per row [B, H]); the energy vector's gradient is the sum of the
    last over rows. Masked keys have weight exactly 0, so no mask is needed,
    except on an all-masked row, where (as in the JAX function) the uniform
    weights pass a gradient that autograd through the -1e9 fill would not.
    """
    d_w = torch.bmm(projected_keys, d_context[:, :, None])[..., 0]  # [B, M]
    d_keys = weights[:, :, None] * d_context[:, None, :]
    if d_weights is not None:
        d_w = d_w + d_weights
    inner = torch.sum(weights * d_w, dim=-1, keepdim=True)
    d_scores = weights * (d_w - inner)
    hidden = torch.tanh(projected_queries[:, None, :] + projected_keys)
    d_pre = d_scores[:, :, None] * energy_w[None, None, :, 0] \
        * (1.0 - hidden * hidden)
    d_energy_rows = torch.sum(hidden * d_scores[:, :, None], dim=1)
    return torch.sum(d_pre, dim=1), d_keys + d_pre, d_energy_rows


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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (projected_queries, projected_keys,
                                      energy_w)):
        return AdditiveAttention.apply(projected_queries, projected_keys,
                                       mask, energy_w)
    return _launch(projected_queries, projected_keys, mask, energy_w)


def kernel_form(projected_keys: torch.Tensor,
                projected_queries: torch.Tensor) -> str:
    """The kernel's form for these dtypes: ``"float32"`` (every input
    float32) or ``"bf16"`` (bf16 keys; queries, energy vector and mask all
    float32 or all bf16). Raises ``TypeError`` for keys of another dtype."""
    if projected_keys.dtype == torch.float32:
        return "float32"
    if projected_keys.dtype == torch.bfloat16 and projected_queries.dtype in (
            torch.float32, torch.bfloat16):
        return "bf16"
    raise TypeError(
        "additive_attention takes float32 keys with float32 queries, or "
        "bf16 keys with float32 or bf16 queries; got keys {}, queries "
        "{}".format(projected_keys.dtype, projected_queries.dtype))


def _launch(projected_queries, projected_keys, mask, energy_w):
    """Kernel 1 on the card: picks its form from the dtypes, checks its
    inputs, launches it, counts it."""
    global launches, launches_bf16
    device = projected_keys.device
    batch, m, h = projected_keys.shape
    form = kernel_form(projected_keys, projected_queries)
    # The dtype of the queries, energy vector and mask.
    small = torch.float32 if form == "float32" else projected_queries.dtype
    tensors = [("projected_queries", projected_queries, (batch, h), small),
               ("projected_keys", projected_keys, (batch, m, h),
                projected_keys.dtype),
               ("energy_w", energy_w, (h, 1), small)]
    if mask is not None:
        tensors.append(("mask", mask, (batch, m), small))
    for name, tensor, shape, dtype in tensors:
        check_tensor(name, tensor, shape, dtype, device)
    context = torch.empty((batch, h), device=device, dtype=torch.float32)
    weights = torch.empty((batch, m), device=device, dtype=torch.float32)
    if batch == 0:
        return context, weights
    lib = _build.library()
    mask_ptr = mask.data_ptr() if mask is not None else None
    stream = torch.cuda.current_stream(device).cuda_stream
    if form == "float32":
        vec = h % 4 == 0 and projected_keys.data_ptr() % 16 == 0
        code = lib.gscan_additive_attention(
            projected_queries.data_ptr(), projected_keys.data_ptr(),
            mask_ptr, energy_w.data_ptr(), context.data_ptr(),
            weights.data_ptr(), batch, m, h, int(vec), stream)
        _build.check(code, "gscan_additive_attention")
        launches += 1
    else:  # the kernel picks its loads from H and the keys' alignment
        code = lib.gscan_additive_attention_bf16(
            projected_queries.data_ptr(), projected_keys.data_ptr(),
            mask_ptr, energy_w.data_ptr(), context.data_ptr(),
            weights.data_ptr(), batch, m, h,
            int(small == torch.bfloat16), stream)
        _build.check(code, "gscan_additive_attention_bf16")
        launches_bf16 += 1
    return context, weights


class AdditiveAttention(torch.autograd.Function):
    """Kernel 1 as a differentiable op: the CUDA forward, and the plain
    :func:`attention_vjp_plain` as its backward."""

    @staticmethod
    def forward(ctx, projected_queries, projected_keys, mask, energy_w):
        context, weights = _launch(projected_queries, projected_keys, mask,
                                   energy_w)
        ctx.save_for_backward(projected_queries, projected_keys, energy_w,
                              weights)
        return context, weights

    @staticmethod
    def backward(ctx, d_context, d_weights):
        projected_queries, projected_keys, energy_w, weights = \
            ctx.saved_tensors
        d_pq, d_keys, d_energy_rows = attention_vjp_plain(
            projected_queries, projected_keys, weights, energy_w, d_context,
            d_weights)
        return d_pq, d_keys, None, d_energy_rows.sum(dim=0)[:, None]
