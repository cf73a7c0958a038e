"""Neural building blocks: LSTM scans, additive attention, the situation
CNN, dropout.

PyTorch counterparts of the JAX package's ``models/nn.py``. Batch-first, with
the same layouts at the public functions (NHWC situations, HWIO conv weights,
``[4H, in]`` LSTM weights), so the two packages can be compared on the same
inputs.
"""

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from multimodal_seq2seq_gscan_tpu_torch.models.params import (
    AttentionParams, CNNParams, LSTMLayerParams)
from multimodal_seq2seq_gscan_tpu_torch.ops import (
    additive_attention as attention_op)


def lstm_cell(params: LSTMLayerParams, x: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step. Gate order i, f, g, o (PyTorch layout).

    x: [B, input], h/c: [B, H] -> (h', c').
    """
    gates = x @ params.w_ih.T + h @ params.w_hh.T + params.b_ih + params.b_hh
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def masked_lstm_scan(params: LSTMLayerParams, inputs: torch.Tensor,
                     mask: torch.Tensor,
                     init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Run an LSTM over time with per-position validity masking.

    At masked (padded) positions the carry is held and the output is zero:
    the packed-sequence semantics of the reference encoder.

    inputs: [B, T, input], mask: [B, T] (1.0 = valid).
    Returns outputs [B, T, H] and the final (h, c) (state at the last valid
    step).
    """
    batch, steps = inputs.shape[:2]
    hidden = params.w_hh.shape[1]
    if init is None:
        h = inputs.new_zeros((batch, hidden))
        c = inputs.new_zeros((batch, hidden))
    else:
        h, c = init
    outputs = []
    for t in range(steps):
        h_new, c_new = lstm_cell(params, inputs[:, t], h, c)
        m = mask[:, t, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        outputs.append(h_new * m)
    return torch.stack(outputs, dim=1), (h, c)


def reverse_padded(sequence: torch.Tensor, lengths: torch.Tensor
                   ) -> torch.Tensor:
    """Reverse the valid prefix of each padded sequence: [a b c 0 0] -> [c b a 0 0].

    An involution: applying it twice restores the original. sequence: [B, T, ...].
    """
    max_len = sequence.shape[1]
    positions = torch.arange(max_len, device=sequence.device)[None, :]
    rev_idx = lengths.long()[:, None] - 1 - positions           # [B, T]
    rev_idx = torch.where(rev_idx >= 0, rev_idx, positions)
    rev_idx = rev_idx.reshape(rev_idx.shape + (1,) * (sequence.ndim - 2))
    return torch.gather(sequence, 1, rev_idx.expand_as(sequence))


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] float mask (1.0 where position < length)."""
    positions = torch.arange(max_len, device=lengths.device)[None, :]
    return (positions < lengths[:, None]).float()


def additive_attention(params: AttentionParams, queries: torch.Tensor,
                       projected_keys: torch.Tensor,
                       mask: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bahdanau attention: energy = v . tanh(W_q q + W_k k), masked softmax.

    queries: [B, Q], projected_keys: [B, M, H] (also the values, as at every
    call site of the reference), mask: [B, M] or None (all valid).
    Returns (context [B, H], weights [B, M]). The part after the query
    projection is ``ops.additive_attention``: a CUDA kernel on the card.
    """
    projected_queries = queries @ params.query_w                   # [B, H]
    return attention_op.additive_attention(
        projected_queries, projected_keys, mask, params.energy_w)


def situation_cnn(params: CNNParams, images: torch.Tensor,
                  kernel_size: int) -> torch.Tensor:
    """Three parallel same-padding convs (k=1, 5, K) over the situation grid.

    images: [B, H, W, C] (NHWC, as in the JAX package). Weights are HWIO and
    are re-laid to OIHW here (``permute(3, 2, 0, 1)``); the grid orientation
    is the JAX package's, with no H/W swap.
    Returns [B, H*W, 3*O] after channel-concat (pre-activation).
    """
    x = images.permute(0, 3, 1, 2)                                 # NCHW

    def conv(w, b, k):
        return F.conv2d(x, w.permute(3, 2, 0, 1), b, padding=k // 2)

    features = torch.cat([conv(params.conv1_w, params.conv1_b, 1),
                          conv(params.conv5_w, params.conv5_b, 5),
                          conv(params.convk_w, params.convk_b, kernel_size)],
                         dim=1)                                    # [B, 3O, H, W]
    batch, channels = features.shape[:2]
    return features.permute(0, 2, 3, 1).reshape(batch, -1, channels)


def embed(embedding: torch.Tensor, token_ids: torch.Tensor,
          padding_idx: int) -> torch.Tensor:
    """Embedding lookup with the padding row pinned to zero at lookup."""
    vectors = F.embedding(token_ids.long(), embedding)
    return vectors * (token_ids != padding_idx)[..., None].to(vectors.dtype)


class RowShard(NamedTuple):
    """A dropout generator of a data-parallel rank: it draws the masks of
    the global batch of ``rows`` rows, as one process would, and keeps
    the rank's rows ``start:start + len`` of each. Every rank draws the
    same numbers, so the ranks together apply one process's masks."""

    generator: torch.Generator
    rows: int
    start: int


def uniform(generator, shape: Tuple[int, ...], device,
            batch_axis: int = 0) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator``, a torch.Generator or a
    ``RowShard`` (then the global batch's draw, narrowed on
    ``batch_axis``)."""
    if not isinstance(generator, RowShard) \
            or generator.rows == shape[batch_axis]:
        if isinstance(generator, RowShard):
            generator = generator.generator
        return torch.rand(shape, generator=generator, device=device)
    full = list(shape)
    full[batch_axis] = generator.rows
    draw = torch.rand(full, generator=generator.generator, device=device)
    return draw.narrow(batch_axis, generator.start,
                       shape[batch_axis]).contiguous()


def dropout(generator, x: torch.Tensor, rate: float,
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout drawn from ``generator`` (see ``uniform``); the
    identity when ``deterministic`` or ``rate == 0``."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = uniform(generator, x.shape, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
