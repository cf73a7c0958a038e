"""The encoder kernel: one encoder LSTM layer's whole masked recurrence,
both directions, in one kernel.

It replaces no TPU kernel: the JAX package's encoder is plain XLA. In the
port the encoder's loop (``models/nn.py::masked_lstm_scan`` over every
padded position, and ``reverse_padded`` around the backward direction) cost
about 22 small launches a position and direction, ~700 a decode batch, and
most of those positions are padding. CUDA source: ``csrc/encoder_lstm.cu``.

On the H100 the layer is bound by operations (~24 GFLOP a 16,384-row decode
batch at H = 100, against ~105 MB of output). Each CTA owns a tile of rows
(taken longest first, so a tile's rows are of like length) and runs both
directions in turn, each to its tile's longest row, with h and c on the
chip across steps: every step's gate product is register tiled (4 rows x 2
units x 4 gates a thread, so the cell's epilogue is the thread's own and
no [B, 4H] gate tensor reaches device memory) over weights streamed from
L2 through a ring in shared memory, from a copy that a first, small kernel
of the same call lays out as the stages take them. The source note has the
details. ``layer_plan`` picks the rows a CTA owns (64 where its
activations fit shared memory, fewer where they do not, or where the batch
would leave SMs idle) and the passes over the units (at most 64 units a
pass); past 4 rows' shared memory the activations live in a global
scratch.

``encoder_layer`` is the wrapper, for CUDA tensors at any input width and
H. The kernel has no backward; ``models/model.py::encode_input`` takes it
only where no gradient is wanted, and keeps its plain version, the same
layer through ``masked_lstm_scan`` and ``reverse_padded``
(``models/model.py::_scan_layer``), everywhere else.
"""

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from multimodal_seq2seq_gscan_tpu_torch.models.params import LSTMLayerParams
from multimodal_seq2seq_gscan_tpu_torch.ops import _build
from multimodal_seq2seq_gscan_tpu_torch.ops.additive_attention import (
    check_tensor)
from multimodal_seq2seq_gscan_tpu_torch.utils.profiling import count

launches = 0  # kernel launches (one a layer), counted by the wrapper

ROW_TILES = (64, 32, 16, 8, 4)  # rows a CTA owns, the plan's choices
MAX_UNITS = 64  # units of H a pass takes
MAX_THREADS = 400  # a CTA's threads: rows / 4 x unit groups


class Plan(NamedTuple):
    rows: int          # rows a CTA owns
    unit_groups: int   # threads across the units (2 units each) of a pass
    passes: int        # passes over H a step
    scratch: bool      # activations and c in a global scratch


@functools.lru_cache(maxsize=None)
def layer_plan(batch: int, in_size: int, hidden: int, device: int) -> Plan:
    """The launch's plan on CUDA device ``device``: the largest row tile
    within the CTA's threads whose shared memory fits a CTA, halved while
    the batch would give fewer CTAs than the device has SMs; a global
    scratch where not even 4 rows' activations fit."""
    passes = -(-hidden // MAX_UNITS)
    per_pass = -(-hidden // passes)
    unit_groups = -(-per_pass // 2)
    lib = _build.library()
    have = _build.shared_memory_per_block(device)

    def need(rows, scratch):
        return lib.gscan_encoder_lstm_shared_bytes(rows, in_size, hidden,
                                                   unit_groups, int(scratch))

    tiles = [rows for rows in ROW_TILES
             if rows // 4 * unit_groups <= MAX_THREADS]
    fitting = [rows for rows in tiles if need(rows, False) <= have]
    rows = fitting[0] if fitting else tiles[0]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    while rows > ROW_TILES[-1] and -(-batch // rows) < sms:
        rows //= 2
    scratch = not fitting
    if need(rows, scratch) > have:
        _build.refuse_shared_memory("encoder", need(rows, scratch), have)
    return Plan(rows, unit_groups, passes, scratch)


def encoder_layer(x: torch.Tensor, lengths: torch.Tensor,
                  forward: LSTMLayerParams,
                  backward: Optional[LSTMLayerParams], *,
                  sum_directions: bool, with_hidden: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One encoder LSTM layer through the kernel.

    x [B, T, In] (the layer's input, float32 on CUDA), lengths [B]
    (clamped to 0..T), each direction's ``LSTMLayerParams`` (``backward``
    None for a unidirectional layer). Step t of a row runs only while t <
    its length, at position t forward and length - 1 - t backward, and
    writes its h there; its carry is held past its length and its other
    positions are zero. Returns the output [B, T, H] (the directions' sum
    where ``sum_directions`` or there is one direction, else their
    concatenation [B, T, 2H]) and, where ``with_hidden``, the sum of the
    directions' final h [B, H], else None. The kernel has no backward: it
    raises when grad mode is on and an input requires grad, rather than
    return outputs without a graph.
    """
    directions = [p for p in (forward, backward) if p is not None]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *(w for p in directions for w in p))):
        raise RuntimeError("encoder_layer has no backward: call it under "
                           "torch.no_grad() or on detached inputs")
    device = x.device
    if device.type != "cuda":
        raise ValueError("encoder_layer runs on cuda, not {}".format(device))
    global launches
    batch, steps, in_size = x.shape
    hidden_size = forward.w_hh.shape[1]
    f32 = torch.float32
    lengths = lengths.to(torch.int32).contiguous()
    check_tensor("x", x, (batch, steps, in_size), f32, device)
    check_tensor("lengths", lengths, (batch,), torch.int32, device)
    shapes = LSTMLayerParams((4 * hidden_size, in_size),
                             (4 * hidden_size, hidden_size),
                             (4 * hidden_size,), (4 * hidden_size,))
    for d, params in enumerate(directions):
        for name, weight, shape in zip(LSTMLayerParams._fields, params,
                                       shapes):
            check_tensor("{}[{}]".format(name, d), weight, shape, f32, device)
    summed = sum_directions or len(directions) == 1
    width = hidden_size if summed else len(directions) * hidden_size
    out = torch.empty((batch, steps, width), device=device, dtype=f32)
    hidden = (torch.empty((batch, hidden_size), device=device, dtype=f32)
              if with_hidden else None)
    if batch == 0 or steps == 0:
        if hidden is not None:
            hidden.zero_()
        return out, hidden
    plan = layer_plan(batch, in_size, hidden_size,
                      _build.device_index(device))
    lib = _build.library()
    scratch = None
    if plan.scratch:
        blocks = -(-batch // plan.rows)
        scratch = torch.empty(
            blocks * lib.gscan_encoder_lstm_scratch_floats(
                plan.rows, in_size, hidden_size, plan.unit_groups),
            device=device, dtype=f32)
    packed = torch.empty(len(directions) * (in_size + hidden_size) * 4
                         * hidden_size, device=device, dtype=f32)
    pointers = [t.data_ptr() for t in forward]
    pointers += ([t.data_ptr() for t in backward] if backward is not None
                 else [None] * 4)
    # The CTAs' tiles take the rows longest first: a tile of like lengths
    # runs few steps past its rows' own.
    order = torch.argsort(lengths, descending=True).to(torch.int32)
    code = lib.gscan_encoder_lstm(
        x.data_ptr(), lengths.data_ptr(), order.data_ptr(), *pointers,
        out.data_ptr(),
        None if hidden is None else hidden.data_ptr(),
        None if scratch is None else scratch.data_ptr(), packed.data_ptr(),
        batch, steps,
        in_size, hidden_size, len(directions), int(summed), plan.rows,
        plan.unit_groups, plan.passes,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(code, "gscan_encoder_lstm")
    launches += 1
    count("encoder_kernel_layers")
    return out, hidden
