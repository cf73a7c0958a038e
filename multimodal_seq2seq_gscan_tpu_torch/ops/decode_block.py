"""Kernel 2: K greedy decoder steps per launch (the fused decode block).

Replaces the TPU kernel ``multimodal_seq2seq_gscan_tpu/ops/pallas_decoder.py``
(``fused_decode_block``), with ``pack_decoder_weights`` from the same file.
CUDA source: ``csrc/decode_block.cu`` (attention rows from
``csrc/attend.cuh``, shared with kernel 1).

On the H100 a block launch is bound by operations: every emitting row-step
does about 0.5 MFLOP of f32 products with ~1 MB of decoder weights, against
~21 KB of projected keys, and a row that is done needs none of it. The
kernel's design (the source note has the details):

- the done-row rule: a done row's outputs are fixed (token and emitted 0,
  h and c frozen, and both attention rows a function of the frozen h and the
  keys), so it takes the attention part of one step, at its first done step
  (step 0 if done at entry), and those two rows are copied to the rest of
  the block, bit for bit what every step would compute; it never runs the
  LSTM, the head or the argmax, and a CTA whose rows are all done stops;
- rows are dealt to the CTAs emitting-first, round robin, so the few rows
  still emitting in a decode's second block spread over every SM, and each
  CTA keeps its emitting rows in the first slots (compacted every step);
- the products run as register tiles (8 rows x 4 columns, each tile's
  weight rows split over up to 16 threads and their sums added by shuffles)
  over weight tiles streamed from L2 through a ring of 3 slots in shared
  memory, filled by every thread's ``cp.async`` (16 bytes, or 4 where
  H % 4 != 0 or a weight is not 16-byte aligned) two tiles ahead;
- each attention row is one pass over its keys (the score and the context
  together, by an online softmax), on one warp, or on several warps that
  split the keys when few rows attend.

A plan (``block_plan``, the source's plan table) picks 32, 16 or 8 rows per
CTA and 32 or 16 KB ring slots: the first that takes H and fits the
device's shared memory per CTA at these shapes. The ring plans take H up to
256: past it a gate item's sum runs over more than 1024 terms in one
thread, and the kernel's c drifted further from float64 than the plain
version's (PERF.md). Past them the grid plan (``csrc/decode_grid.cu``) runs
each product of a step over the whole batch's rows at once, on the shared
128 x 256 register tiles of ``csrc/product_core.cuh``: a persistent
cooperative launch of one CTA per SM, the step's phases separated by grid
barriers, the activations in a global scratch that the wrapper allocates
(``9 H + P`` floats a row, slots padded to 4, where the products' k-split
sums take P = ``16 H``, or more where the widest product needs more parts
to keep every sum within 1,024 terms; and the folded head ``W_out W_proj``,
``4 H V`` floats), so that each weight is read once a step for every 128
rows rather than once for every 8. Its shared memory is the product ring's
147,456 bytes at every H, M and V (past H = 1,024 an attention row's query
is staged in the scratch), so on the H100 (232,448 bytes a CTA) the table
takes every shape.

``fused_decode_block`` is the wrapper: the plain version for CPU tensors, the
kernel for CUDA tensors. The kernel takes any M and H, and the wrapper
raises, before any launch, only where no plan fits the device's shared
memory per CTA (naming the bytes needed and available).
"""

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from multimodal_seq2seq_gscan_tpu_torch.models.params import ModelParams
from multimodal_seq2seq_gscan_tpu_torch.ops import _build
from multimodal_seq2seq_gscan_tpu_torch.ops.additive_attention import (
    additive_attention_plain, check_tensor)

launches = 0  # kernel launches, counted by the wrapper


class DecoderWeights(NamedTuple):
    """The decoder weights in the kernel's layouts (``pack_decoder_weights``)."""

    txt_qw: torch.Tensor    # [H, H]
    txt_ew: torch.Tensor    # [H, 1]
    q2k_w: torch.Tensor     # [2H, H]
    q2k_b: torch.Tensor     # [1, H]
    vis_qw: torch.Tensor    # [H, H]
    vis_ew: torch.Tensor    # [H, 1]
    embedding: torch.Tensor  # [V, H], pad row zeroed
    w_ih: torch.Tensor      # [3H, 4H] (transposed)
    w_hh: torch.Tensor      # [H, 4H] (transposed)
    bias: torch.Tensor      # [1, 4H] = b_ih + b_hh
    out_w: torch.Tensor     # [4H, H]
    out_proj: torch.Tensor  # [H, V]


class BlockOutput(NamedTuple):
    h: torch.Tensor              # [B, H] carried state after the block
    c: torch.Tensor              # [B, H]
    tokens: torch.Tensor         # [B] int32, last emitted token
    done: torch.Tensor           # [B] bool
    step_tokens: torch.Tensor    # [K, B] int32 (0 once done)
    step_emitted: torch.Tensor   # [K, B] float32 (1.0 while emitting)
    step_attn_cmd: torch.Tensor  # [K, B, M_t]
    step_attn_sit: torch.Tensor  # [K, B, M_v]


def pack_decoder_weights(params: ModelParams, pad_idx: int) -> DecoderWeights:
    """The decoder weights as the kernel takes them, contiguous float32.

    Requires one decoder layer and conditional attention (the flagship
    configuration). The embedding's pad row is zeroed here, because
    ``models.nn.embed`` zeroes pad lookups rather than trusting the row.
    """
    if len(params.decoder.lstm_layers) != 1:
        raise ValueError("the decode block takes one decoder layer")
    if params.decoder.queries_to_keys_w is None:
        raise ValueError("the decode block needs conditional attention")
    layer = params.decoder.lstm_layers[0]
    embedding = params.decoder.embedding.clone()
    embedding[pad_idx] = 0.0
    weights = DecoderWeights(
        txt_qw=params.textual_attention.query_w,
        txt_ew=params.textual_attention.energy_w,
        q2k_w=params.decoder.queries_to_keys_w,
        q2k_b=params.decoder.queries_to_keys_b[None, :],
        vis_qw=params.visual_attention.query_w,
        vis_ew=params.visual_attention.energy_w,
        embedding=embedding,
        w_ih=layer.w_ih.T,
        w_hh=layer.w_hh.T,
        bias=(layer.b_ih + layer.b_hh)[None, :],
        out_w=params.decoder.output_to_hidden_w,
        out_proj=params.decoder.hidden_to_output_w)
    return DecoderWeights(*(w.float().contiguous() for w in weights))


def decode_block_plain(proj_textual: torch.Tensor, cmd_mask: torch.Tensor,
                       proj_visual: torch.Tensor, h: torch.Tensor,
                       c: torch.Tensor, tokens: torch.Tensor,
                       done: torch.Tensor, weights: DecoderWeights, *,
                       num_steps: int, eos_idx: int,
                       top2_gap: Optional[list] = None) -> BlockOutput:
    """Plain PyTorch version: the same function as the kernel.

    proj_textual [B, M_t, H], cmd_mask [B, M_t], proj_visual [B, M_v, H],
    h/c [B, H], tokens [B] int32 (last emitted, or SOS), done [B] bool.
    With ``top2_gap`` (a list), each step appends the gap between the two
    largest logits of every row ([B]), which tells an argmax near-tie.
    """
    w = weights
    step_tokens, step_emitted, step_attn_cmd, step_attn_sit = [], [], [], []
    tokens = tokens.to(torch.int32)
    for _ in range(num_steps):
        embedded = w.embedding[tokens.long()]
        ctx_cmd, attn_cmd = additive_attention_plain(
            h @ w.txt_qw, proj_textual, cmd_mask, w.txt_ew)
        visual_query = torch.tanh(torch.cat([h, ctx_cmd], dim=-1) @ w.q2k_w
                                  + w.q2k_b)
        ctx_sit, attn_sit = additive_attention_plain(
            visual_query @ w.vis_qw, proj_visual, None, w.vis_ew)
        gates = (torch.cat([embedded, ctx_cmd, ctx_sit], dim=-1) @ w.w_ih
                 + h @ w.w_hh + w.bias)
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h_new = torch.sigmoid(go) * torch.tanh(c_new)
        pre = torch.cat([embedded, h_new, ctx_cmd, ctx_sit], dim=-1)
        logits = (pre @ w.out_w) @ w.out_proj
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        if top2_gap is not None:
            top2 = torch.topk(logits, 2, dim=-1).values
            top2_gap.append(top2[:, 0] - top2[:, 1])

        emitting = ~done
        keep = emitting[:, None]
        h = torch.where(keep, h_new, h)
        c = torch.where(keep, c_new, c)
        step_tokens.append(torch.where(emitting, next_tokens,
                                       torch.zeros_like(next_tokens)))
        step_emitted.append(emitting.float())
        tokens = torch.where(emitting, next_tokens, tokens)
        done = done | (next_tokens == eos_idx)
        step_attn_cmd.append(attn_cmd)
        step_attn_sit.append(attn_sit)
    return BlockOutput(h, c, tokens, done, torch.stack(step_tokens),
                       torch.stack(step_emitted), torch.stack(step_attn_cmd),
                       torch.stack(step_attn_sit))


class BlockPlan(NamedTuple):
    """A plan of kernel 2 (``csrc/decode_block.cu``'s plan table)."""

    index: int
    rows: int         # batch rows per CTA (0: the grid plan)
    slot_floats: int  # floats per weight-ring slot (0: the grid plan)
    grid: bool        # the grid plan (``csrc/decode_grid.cu``)

    def describe(self) -> str:
        if self.grid:
            return "plan {}: grid-wide products (one CTA per SM, 128 x 256 " \
                "register tiles), weights read once a step".format(
                    self.index)
        return "plan {}: {} rows per CTA, {}-float weight slots".format(
            self.index, self.rows, self.slot_floats)


@functools.lru_cache(maxsize=None)
def block_plan(hidden: int, vocab: int, m_t: int, m_v: int,
               device_index: int) -> BlockPlan:
    """The plan kernel 2 takes at these shapes on CUDA device
    ``device_index``: the first of its plans (32 rows a CTA and 32 KB slots
    first) that takes H and whose shared memory fits what the device allows
    a CTA. Raises ``ValueError`` where none fits (naming the bytes needed
    and available)."""
    have = _build.shared_memory_per_block(device_index)
    need = ctypes.c_longlong(0)
    lib = _build.library()
    plan = lib.gscan_decode_block_plan(hidden, vocab, m_t, m_v, have,
                                       ctypes.byref(need))
    if plan < 0:
        _build.refuse_shared_memory("fused_decode_block", need.value, have)
    return BlockPlan(plan, lib.gscan_decode_block_plan_rows(plan),
                     lib.gscan_decode_block_plan_slot_floats(plan),
                     bool(lib.gscan_decode_block_plan_grid(plan)))


def fused_decode_block(proj_textual: torch.Tensor, cmd_mask: torch.Tensor,
                       proj_visual: torch.Tensor, h: torch.Tensor,
                       c: torch.Tensor, tokens: torch.Tensor,
                       done: torch.Tensor, weights: DecoderWeights, *,
                       num_steps: int, eos_idx: int) -> BlockOutput:
    """``num_steps`` greedy decoder steps: the kernel on CUDA, plain on CPU.

    Same arguments and results as :func:`decode_block_plain`. The inputs are
    not modified; every output is a new tensor. The kernel has no backward:
    it raises when grad mode is on and an input requires grad, rather than
    return outputs without a graph.
    """
    device = proj_textual.device
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (proj_textual, cmd_mask, proj_visual, h,
                                      c, *weights)):
        raise RuntimeError("fused_decode_block has no backward: call it "
                           "under torch.no_grad() or on detached inputs")
    if device.type == "cpu":
        return decode_block_plain(proj_textual, cmd_mask, proj_visual, h, c,
                                  tokens, done, weights, num_steps=num_steps,
                                  eos_idx=eos_idx)
    if device.type != "cuda":
        raise ValueError("fused_decode_block runs on cpu or cuda, not "
                         "{}".format(device))
    batch, m_t, hidden = proj_textual.shape
    m_v = proj_visual.shape[1]
    vocab = weights.embedding.shape[0]
    if num_steps <= 0:
        raise ValueError("num_steps must be positive, got {}".format(
            num_steps))
    f32 = torch.float32
    for name, tensor, shape, dtype in (
            ("proj_textual", proj_textual, (batch, m_t, hidden), f32),
            ("cmd_mask", cmd_mask, (batch, m_t), f32),
            ("proj_visual", proj_visual, (batch, m_v, hidden), f32),
            ("h", h, (batch, hidden), f32), ("c", c, (batch, hidden), f32),
            ("tokens", tokens, (batch,), torch.int32),
            ("done", done, (batch,), torch.bool)):
        check_tensor(name, tensor, shape, dtype, device)
    shapes = DecoderWeights(
        (hidden, hidden), (hidden, 1), (2 * hidden, hidden), (1, hidden),
        (hidden, hidden), (hidden, 1), (vocab, hidden),
        (3 * hidden, 4 * hidden), (hidden, 4 * hidden), (1, 4 * hidden),
        (4 * hidden, hidden), (hidden, vocab))
    for name, weight, shape in zip(DecoderWeights._fields, weights, shapes):
        check_tensor(name, weight, shape, f32, device)

    def empty(shape, dtype=f32):
        return torch.empty(shape, device=device, dtype=dtype)

    out = BlockOutput(
        empty((batch, hidden)), empty((batch, hidden)),
        empty((batch,), torch.int32), empty((batch,), torch.bool),
        empty((num_steps, batch), torch.int32), empty((num_steps, batch)),
        empty((num_steps, batch, m_t)), empty((num_steps, batch, m_v)))
    if batch == 0:
        return out
    plan = block_plan(hidden, vocab, m_t, m_v, _build.device_index(device))
    lib = _build.library()
    scratch_floats = lib.gscan_decode_block_scratch_floats(plan.index, batch,
                                                           hidden, vocab)
    scratch = empty((scratch_floats,)) if scratch_floats else None
    vec = hidden % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (proj_textual, proj_visual, *weights))
    code = lib.gscan_decode_block(
        proj_textual.data_ptr(), cmd_mask.data_ptr(), proj_visual.data_ptr(),
        h.data_ptr(), c.data_ptr(), tokens.data_ptr(), done.data_ptr(),
        *(weight.data_ptr() for weight in weights),
        *(tensor.data_ptr() for tensor in out),
        None if scratch is None else scratch.data_ptr(),
        batch, m_t, m_v, hidden, vocab, num_steps, eos_idx, plan.index,
        int(vec), torch.cuda.current_stream(device).cuda_stream)
    _build.check(code, "gscan_decode_block")
    global launches
    launches += 1
    return out
