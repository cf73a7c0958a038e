"""Kernels 3 and 4: the teacher-forced decoder unroll, forward and backward.

Replace the TPU kernels of ``multimodal_seq2seq_gscan_tpu/ops/
pallas_teacher_forced.py``: ``_forward_impl`` (kernel 3) and
``_backward_impl`` (kernel 4), which ``fused_teacher_forced``'s custom VJP
wires together; here :class:`FusedTeacherForced` does. CUDA source:
``csrc/teacher_forced.cu``.

- Kernel 3 (``teacher_forced_forward``) is kernel 2's decoder step with the
  teacher's token in place of the argmax, a ``[T, B, E]`` dropout mask on
  the embedded token, the pre-step (h, c) stashed as residuals, logits for
  every step, and the visual attention summed over ``t < num_steps``.
- Kernel 4 (``teacher_forced_backward``) walks time in reverse,
  recomputing each step from (h_res, c_res) with kernel 3's step code and
  backpropagating through the head, the LSTM cell and both attentions. The
  weight gradients are sums over rows and steps: the kernel writes each
  row-step's operands (the ``X`` and ``dY`` of every ``X^T dY``) to a
  stash in device memory, and a helper kernel
  (``teacher_forced_weight_grads``) forms the fourteen products, split over
  chunks of row-steps whose sums a second pass adds in chunk order.
- Both give each thread-block cluster (8 CTAs) a group of 16 rows. Each CTA
  of a cluster keeps the column slices of the decoder weights for its share
  of the hidden units in shared memory for the whole walk (kernel 3 also
  its rows' keys); the CTAs exchange activations and partial sums through
  distributed shared memory and add them in rank order. No float atomics:
  the outputs are bit-identical from run to run.

Bound on the H100: operations (a row-step is ~0.5 MFLOP of products with
~1 MB of decoder weights; the residuals are ~10 MB at B=200, T=56), but the
T-step chain makes both recurrent kernels latency-bound in practice.

Kernels 3 and 4 take any M and H. Each runs in one of a few shared-memory
plans: the decoder's weight slices resident in shared memory or read from
L2, kernel 3's keys resident or not, 16 or 8 rows per cluster. Before any
launch the wrapper asks the library for the first plan that fits the
device's shared memory per CTA (:func:`shared_memory_plan`) and raises
``ValueError`` only where none does, naming the bytes needed and available.
On CPU tensors each wrapper runs its plain twin:
``teacher_forced_forward_plain``, ``teacher_forced_backward_plain`` (a
PyTorch port of the TPU backward kernel's step math) and
``weight_grads_plain``. The independent yardstick of all of them is
``teacher_forced_plain``, a Python unroll of the step math differentiated
by autograd (as ``spec_unroll`` is in the JAX tests).
"""

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from multimodal_seq2seq_gscan_tpu_torch.ops import _build
from multimodal_seq2seq_gscan_tpu_torch.ops.additive_attention import (
    additive_attention_plain, attention_vjp_plain, check_tensor)
from multimodal_seq2seq_gscan_tpu_torch.ops.decode_block import (
    DecoderWeights)

# Kernel launches, counted by the wrappers.
launches: Dict[str, int] = {"teacher_forced_forward": 0,
                            "teacher_forced_backward": 0,
                            "teacher_forced_weight_grads": 0}

GRAD_SPLITS = 12  # chunks of row-steps the helper's scratch has room for


class StashLayout(NamedTuple):
    """Column offsets of one row-step in kernel 4's stash ``[T, B, width]``
    (the same layout as ``csrc/teacher_forced.cu``). The ``X`` operands
    come first, then the ``dY`` operands. The one-hot segment is padded
    with zeros to a multiple of 4 columns, so that every later segment
    starts 16-byte aligned when E and H are multiples of 4."""

    onehot: int   # [V] one-hot teacher token, zeros up to emb
    emb: int      # [E] embedded token, dropout applied
    h_new: int    # [H]
    ctx_cmd: int  # [H]
    ctx_sit: int  # [H]
    ph: int       # [H] head's hidden layer
    vq: int       # [H] visual query
    d_ph: int     # [H]
    d_gates: int  # [4H] gate pre-activation gradients, i, f, g, o
    d_pq_vis: int  # [H]
    d_joint: int  # [H] gradient of the visual query's pre-activation
    d_pq_txt: int  # [H]
    d_emb: int    # [E]
    g_vis_ew: int  # [H] per-row sum over keys for the energy vector
    g_txt_ew: int  # [H]
    width: int


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def stash_layout(vocab: int, emb_dim: int, hidden: int) -> StashLayout:
    widths = [_round4(vocab), emb_dim] + [hidden] * 6 + [4 * hidden] \
        + [hidden] * 3 + [emb_dim, hidden, hidden]
    offsets = [0]
    for w in widths:
        offsets.append(offsets[-1] + w)
    return StashLayout(*offsets)


def _sizes(proj_txt, proj_vis, weights):
    batch, m_t, hidden = proj_txt.shape
    vocab, emb_dim = weights.embedding.shape
    return batch, m_t, proj_vis.shape[1], hidden, emb_dim, vocab


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _step_plain(tokens, drop, h, c, proj_txt, cmd_mask, proj_vis,
                w: DecoderWeights):
    """One teacher-forced step (``_step_forward`` of the TPU kernel).

    Returns (logits, h_new, c_new, attn_sit) and the internals the backward
    needs."""
    vocab = w.embedding.shape[0]
    onehot = (tokens[:, None].long()
              == torch.arange(vocab, device=tokens.device)[None]
              ).to(w.embedding.dtype)
    embedded = (onehot @ w.embedding) * drop
    pq_txt = h @ w.txt_qw
    ctx_cmd, attn_cmd = additive_attention_plain(pq_txt, proj_txt, cmd_mask,
                                                 w.txt_ew)
    vq = torch.tanh(torch.cat([h, ctx_cmd], dim=-1) @ w.q2k_w + w.q2k_b)
    pq_vis = vq @ w.vis_qw
    ctx_sit, attn_sit = additive_attention_plain(pq_vis, proj_vis, None,
                                                 w.vis_ew)
    gates = (torch.cat([embedded, ctx_cmd, ctx_sit], dim=-1) @ w.w_ih
             + h @ w.w_hh + w.bias)
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
    h_new = torch.sigmoid(go) * torch.tanh(c_new)
    pre = torch.cat([embedded, h_new, ctx_cmd, ctx_sit], dim=-1)
    ph = pre @ w.out_w
    logits = ph @ w.out_proj
    internals = dict(onehot=onehot, embedded=embedded, pq_txt=pq_txt,
                     ctx_cmd=ctx_cmd, attn_cmd=attn_cmd, vq=vq,
                     pq_vis=pq_vis, ctx_sit=ctx_sit, gates=gates, ph=ph,
                     pre=pre)
    return logits, h_new, c_new, attn_sit, internals


def teacher_forced_forward_plain(proj_txt, cmd_mask, proj_vis, h0, c0,
                                 tokens, drop, weights: DecoderWeights, *,
                                 num_steps: int):
    """Plain version of kernel 3: (logits [T, B, V], h_res [T, B, H],
    c_res [T, B, H], summed visual attention [B, M_v] over t < num_steps)."""
    h, c = h0, c0
    logits, h_res, c_res = [], [], []
    asum = torch.zeros_like(proj_vis[:, :, 0])
    for t in range(tokens.shape[0]):
        h_res.append(h)
        c_res.append(c)
        step_logits, h, c, attn_sit, _ = _step_plain(
            tokens[t], drop[t], h, c, proj_txt, cmd_mask, proj_vis, weights)
        logits.append(step_logits)
        if t < num_steps:
            asum = asum + attn_sit
    return (torch.stack(logits), torch.stack(h_res), torch.stack(c_res),
            asum)


def teacher_forced_plain(proj_txt, cmd_mask, proj_vis, h0, c0, tokens, drop,
                         weights: DecoderWeights, *, num_steps: int):
    """The unroll as plain differentiable PyTorch: (logits [T, B, V],
    summed visual attention [B, M_v]). Its gradients come from autograd."""
    logits, _, _, asum = teacher_forced_forward_plain(
        proj_txt, cmd_mask, proj_vis, h0, c0, tokens, drop, weights,
        num_steps=num_steps)
    return logits, asum


def teacher_forced_backward_plain(proj_txt, cmd_mask, proj_vis, tokens, drop,
                                  weights: DecoderWeights, h_res, c_res,
                                  dlogits, g_asum, *, num_steps: int):
    """Plain version of kernel 4: the TPU backward kernel's step math
    (``_make_bwd_kernel``), walking time in reverse from the residuals.

    Returns (d_proj_txt, d_proj_vis, dh0, dc0, stash [T, B, width]); the
    weight gradients are ``weight_grads_plain`` of the stash."""
    w = weights
    steps = tokens.shape[0]
    batch, _, _, hidden, emb_dim, vocab = _sizes(proj_txt, proj_vis, w)
    stash = []
    d_proj_txt = torch.zeros_like(proj_txt)
    d_proj_vis = torch.zeros_like(proj_vis)
    dh = torch.zeros_like(h_res[0])
    dc = torch.zeros_like(c_res[0])
    for t in reversed(range(steps)):
        h, c = h_res[t], c_res[t]
        _, h_new, c_new, attn_sit, x = _step_plain(
            tokens[t], drop[t], h, c, proj_txt, cmd_mask, proj_vis, w)
        gi, gf, gg, go = x["gates"].chunk(4, dim=-1)
        si, sf, so = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
        tg, tc = torch.tanh(gg), torch.tanh(c_new)

        d_ph = dlogits[t] @ w.out_proj.T
        d_pre = d_ph @ w.out_w.T
        d_e2, d_hn2, d_cc2, d_cs2 = torch.split(
            d_pre, [emb_dim, hidden, hidden, hidden], dim=-1)
        dh_new = dh + d_hn2
        do_pre = dh_new * tc * so * (1.0 - so)
        dct = dc + dh_new * so * (1.0 - tc * tc)
        df_pre = dct * c * sf * (1.0 - sf)
        di_pre = dct * tg * si * (1.0 - si)
        dg_pre = dct * si * (1.0 - tg * tg)
        d_gates = torch.cat([di_pre, df_pre, dg_pre, do_pre], dim=-1)
        d_lstm_in = d_gates @ w.w_ih.T
        dh_lstm = d_gates @ w.w_hh.T
        d_e1, d_cc1, d_cs1 = torch.split(d_lstm_in,
                                         [emb_dim, hidden, hidden], dim=-1)

        valid = 1.0 if t < num_steps else 0.0
        d_pq_vis, d_keys_vis, g_vis_ew = attention_vjp_plain(
            x["pq_vis"], proj_vis, attn_sit, w.vis_ew, d_cs1 + d_cs2,
            g_asum * valid)
        d_proj_vis = d_proj_vis + d_keys_vis
        d_joint_pre = (d_pq_vis @ w.vis_qw.T) * (1.0 - x["vq"] * x["vq"])
        d_joint = d_joint_pre @ w.q2k_w.T
        d_pq_txt, d_keys_txt, g_txt_ew = attention_vjp_plain(
            x["pq_txt"], proj_txt, x["attn_cmd"], w.txt_ew,
            d_cc1 + d_cc2 + d_joint[:, hidden:], None)
        d_proj_txt = d_proj_txt + d_keys_txt
        dh_txt = d_pq_txt @ w.txt_qw.T
        d_emb = (d_e1 + d_e2) * drop[t]
        dh = dh_lstm + d_joint[:, :hidden] + dh_txt
        dc = dct * sf
        pad = x["onehot"].new_zeros((batch, _round4(vocab) - vocab))
        stash.append(torch.cat(
            [x["onehot"], pad, x["embedded"], h_new, x["ctx_cmd"],
             x["ctx_sit"], x["ph"], x["vq"], d_ph, d_gates, d_pq_vis,
             d_joint_pre, d_pq_txt, d_emb, g_vis_ew, g_txt_ew], dim=-1))
    stash = torch.stack(stash[::-1])
    assert stash.shape[-1] == stash_layout(vocab, emb_dim, hidden).width
    return d_proj_txt, d_proj_vis, dh, dc, stash


def weight_grads_plain(stash, h_res, dlogits) -> DecoderWeights:
    """Plain version of the helper kernel: the twelve weight gradients
    ``sum over (t, b) of X^T dY`` from kernel 4's stash."""
    hidden, vocab = h_res.shape[-1], dlogits.shape[-1]
    emb_dim = (stash.shape[-1] - _round4(vocab) - 15 * hidden) // 2
    lay = stash_layout(vocab, emb_dim, hidden)
    x = stash.reshape(-1, lay.width)
    h = h_res.reshape(-1, hidden)
    dl = dlogits.reshape(-1, vocab)

    def cols(start, end):
        return x[:, start:end]

    dg = cols(lay.d_gates, lay.d_pq_vis)
    djp = cols(lay.d_joint, lay.d_pq_txt)
    return DecoderWeights(
        txt_qw=h.T @ cols(lay.d_pq_txt, lay.d_emb),
        txt_ew=cols(lay.g_txt_ew, lay.width).sum(0)[:, None],
        q2k_w=torch.cat([h, cols(lay.ctx_cmd, lay.ctx_sit)], dim=-1).T @ djp,
        q2k_b=djp.sum(0)[None],
        vis_qw=cols(lay.vq, lay.d_ph).T @ cols(lay.d_pq_vis, lay.d_joint),
        vis_ew=cols(lay.g_vis_ew, lay.g_txt_ew).sum(0)[:, None],
        embedding=cols(lay.onehot, lay.onehot + vocab).T
        @ cols(lay.d_emb, lay.g_vis_ew),
        w_ih=torch.cat([cols(lay.emb, lay.h_new),
                        cols(lay.ctx_cmd, lay.ph)], dim=-1).T @ dg,
        w_hh=h.T @ dg,
        bias=dg.sum(0)[None],
        out_w=cols(lay.emb, lay.ph).T @ cols(lay.d_ph, lay.d_gates),
        out_proj=cols(lay.ph, lay.vq).T @ dl)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _weight_shapes(hidden, emb_dim, vocab) -> DecoderWeights:
    return DecoderWeights(
        (hidden, hidden), (hidden, 1), (2 * hidden, hidden), (1, hidden),
        (hidden, hidden), (hidden, 1), (vocab, emb_dim),
        (emb_dim + 2 * hidden, 4 * hidden), (hidden, 4 * hidden),
        (1, 4 * hidden), (emb_dim + 3 * hidden, hidden), (hidden, vocab))


# The kernels' numbers in the library's plan tables.
KERNEL_NUMBERS = {"teacher_forced_forward": 3, "teacher_forced_backward": 4}


@functools.lru_cache(maxsize=None)
def shared_memory_plan(kernel, m_t, m_v, hidden, emb_dim, vocab,
                       device_index):
    """(index, name, bytes per CTA) of the shared-memory plan that
    ``kernel`` ("teacher_forced_forward" or "teacher_forced_backward")
    takes at these shapes on CUDA device ``device_index``: the first of its
    plans (``csrc/teacher_forced.cu``) that fits the shared memory per CTA
    the device reports. Raises ``ValueError`` where none fits."""
    number = KERNEL_NUMBERS[kernel]
    lib = _build.library()
    have = _build.shared_memory_per_block(device_index)
    need = ctypes.c_longlong(0)
    plan = lib.gscan_teacher_forced_plan(number, hidden, emb_dim, vocab, m_t,
                                         m_v, have, ctypes.byref(need))
    if plan < 0:
        _build.refuse_shared_memory(kernel, need.value, have)
    name = lib.gscan_teacher_forced_plan_name(number, plan).decode()
    return plan, name, need.value


def _check_inputs(name, device, proj_txt, cmd_mask, proj_vis, tokens, drop,
                  weights, extra=()):
    if device.type != "cuda":
        raise ValueError("{} runs on cpu or cuda, not {}".format(name,
                                                                 device))
    batch, m_t, m_v, hidden, emb_dim, vocab = _sizes(proj_txt, proj_vis,
                                                     weights)
    steps = tokens.shape[0]
    if steps <= 0:
        raise ValueError("{} takes T > 0, got T={}".format(name, steps))
    f32 = torch.float32
    for arg, tensor, shape, dtype in (
            ("proj_txt", proj_txt, (batch, m_t, hidden), f32),
            ("cmd_mask", cmd_mask, (batch, m_t), f32),
            ("proj_vis", proj_vis, (batch, m_v, hidden), f32),
            ("tokens", tokens, (steps, batch), torch.int32),
            ("drop", drop, (steps, batch, emb_dim), f32)) + tuple(extra):
        check_tensor(arg, tensor, shape, dtype, device)
    for arg, weight, shape in zip(DecoderWeights._fields, weights,
                                  _weight_shapes(hidden, emb_dim, vocab)):
        check_tensor(arg, weight, shape, f32, device)
    return batch, m_t, m_v, hidden, emb_dim, vocab, steps


def _plan(kernel, device, proj_txt, proj_vis, weights):
    """The index of ``kernel``'s shared-memory plan at these shapes; raises,
    before any launch, where none fits."""
    if device.type != "cuda":
        raise ValueError("{} runs on cpu or cuda, not {}".format(kernel,
                                                                 device))
    return shared_memory_plan(kernel,
                              *_sizes(proj_txt, proj_vis, weights)[1:],
                              _build.device_index(device))[0]


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def teacher_forced_forward(proj_txt, cmd_mask, proj_vis, h0, c0, tokens,
                           drop, weights: DecoderWeights, *, num_steps: int):
    """Kernel 3 on CUDA tensors, its plain version on CPU tensors.

    proj_txt [B, M_t, H], cmd_mask [B, M_t], proj_vis [B, M_v, H],
    h0/c0 [B, H], tokens [T, B] int32, drop [T, B, E], weights packed by
    ``pack_decoder_weights``. Returns (logits [T, B, V], h_res, c_res
    [T, B, H] (the state before each step), summed visual attention
    [B, M_v] over t < num_steps).
    """
    device = proj_txt.device
    if device.type == "cpu":
        return teacher_forced_forward_plain(
            proj_txt, cmd_mask, proj_vis, h0, c0, tokens, drop, weights,
            num_steps=num_steps)
    plan = _plan("teacher_forced_forward", device, proj_txt, proj_vis,
                 weights)
    batch, m_t, m_v, hidden, emb_dim, vocab, steps = _check_inputs(
        "teacher_forced_forward", device, proj_txt, cmd_mask, proj_vis,
        tokens, drop, weights,
        extra=(("h0", h0, (proj_txt.shape[0], proj_txt.shape[2]),
                torch.float32),
               ("c0", c0, (proj_txt.shape[0], proj_txt.shape[2]),
                torch.float32)))
    logits = torch.empty((steps, batch, vocab), device=device)
    h_res = torch.empty((steps, batch, hidden), device=device)
    c_res = torch.empty((steps, batch, hidden), device=device)
    asum = torch.empty((batch, m_v), device=device)
    if batch == 0:
        return logits, h_res, c_res, asum
    code = _build.library().gscan_teacher_forced_forward(
        tokens.data_ptr(), drop.data_ptr(), proj_txt.data_ptr(),
        cmd_mask.data_ptr(), proj_vis.data_ptr(), h0.data_ptr(),
        c0.data_ptr(), *(w.data_ptr() for w in weights), logits.data_ptr(),
        h_res.data_ptr(), c_res.data_ptr(), asum.data_ptr(), batch, steps,
        num_steps, m_t, m_v, hidden, emb_dim, vocab, plan, _stream(device))
    _build.check(code, "gscan_teacher_forced_forward")
    launches["teacher_forced_forward"] += 1
    return logits, h_res, c_res, asum


def teacher_forced_backward(proj_txt, cmd_mask, proj_vis, tokens, drop,
                            weights: DecoderWeights, h_res, c_res, dlogits,
                            g_asum, *, num_steps: int):
    """Kernel 4 on CUDA tensors, its plain version on CPU tensors.

    Takes kernel 3's inputs and residuals, the logits' cotangent
    [T, B, V] and the summed attention's [B, M_v]. Returns (d_proj_txt,
    d_proj_vis, dh0, dc0, stash [T, B, width]); feed the stash to
    :func:`teacher_forced_weight_grads`.
    """
    device = proj_txt.device
    if device.type == "cpu":
        return teacher_forced_backward_plain(
            proj_txt, cmd_mask, proj_vis, tokens, drop, weights, h_res,
            c_res, dlogits, g_asum, num_steps=num_steps)
    plan = _plan("teacher_forced_backward", device, proj_txt, proj_vis,
                 weights)
    batch, _, hidden = proj_txt.shape
    m_v = proj_vis.shape[1]
    batch, m_t, m_v, hidden, emb_dim, vocab, steps = _check_inputs(
        "teacher_forced_backward", device, proj_txt, cmd_mask, proj_vis,
        tokens, drop, weights,
        extra=(("h_res", h_res, (tokens.shape[0], batch, hidden),
                torch.float32),
               ("c_res", c_res, (tokens.shape[0], batch, hidden),
                torch.float32),
               ("dlogits", dlogits,
                (tokens.shape[0], batch, weights.out_proj.shape[1]),
                torch.float32),
               ("g_asum", g_asum, (batch, m_v), torch.float32)))
    d_proj_txt = torch.zeros_like(proj_txt)
    d_proj_vis = torch.zeros_like(proj_vis)
    dh0 = torch.empty((batch, hidden), device=device)
    dc0 = torch.empty((batch, hidden), device=device)
    stash = torch.empty(
        (steps, batch, stash_layout(vocab, emb_dim, hidden).width),
        device=device)
    if batch == 0:
        return d_proj_txt, d_proj_vis, dh0, dc0, stash
    code = _build.library().gscan_teacher_forced_backward(
        tokens.data_ptr(), drop.data_ptr(), proj_txt.data_ptr(),
        cmd_mask.data_ptr(), proj_vis.data_ptr(), h_res.data_ptr(),
        c_res.data_ptr(), dlogits.data_ptr(), g_asum.data_ptr(),
        *(m.data_ptr() for m in weights), d_proj_txt.data_ptr(),
        d_proj_vis.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
        stash.data_ptr(), batch, steps, num_steps, m_t, m_v, hidden, emb_dim,
        vocab, plan, _stream(device))
    _build.check(code, "gscan_teacher_forced_backward")
    launches["teacher_forced_backward"] += 1
    return d_proj_txt, d_proj_vis, dh0, dc0, stash


def teacher_forced_weight_grads(stash, h_res, dlogits) -> DecoderWeights:
    """The helper kernel on CUDA tensors (plain version on CPU tensors): the
    twelve weight gradients from kernel 4's stash, each output summed over
    all (t, b) in an order fixed by the shapes."""
    device = stash.device
    if device.type == "cpu":
        return weight_grads_plain(stash, h_res, dlogits)
    if device.type != "cuda":
        raise ValueError("teacher_forced_weight_grads runs on cpu or cuda, "
                         "not {}".format(device))
    steps, batch, hidden = h_res.shape
    vocab = dlogits.shape[-1]
    emb_dim = (stash.shape[-1] - _round4(vocab) - 15 * hidden) // 2
    width = stash_layout(vocab, emb_dim, hidden).width
    for name, tensor, shape in (("stash", stash, (steps, batch, width)),
                                ("h_res", h_res, (steps, batch, hidden)),
                                ("dlogits", dlogits, (steps, batch, vocab))):
        check_tensor(name, tensor, shape, torch.float32, device)
    shapes = _weight_shapes(hidden, emb_dim, vocab)
    grads = DecoderWeights(*(torch.empty(shape, device=device)
                             for shape in shapes))
    # Each chunk of row-steps' sums, before the second pass adds them.
    partial = torch.empty(GRAD_SPLITS * sum(r * c for r, c in shapes),
                          device=device)
    code = _build.library().gscan_teacher_forced_weight_grads(
        stash.data_ptr(), h_res.data_ptr(), dlogits.data_ptr(),
        *(g.data_ptr() for g in grads), partial.data_ptr(), partial.numel(),
        steps * batch, hidden, emb_dim, vocab, _stream(device))
    _build.check(code, "gscan_teacher_forced_weight_grads")
    launches["teacher_forced_weight_grads"] += 1
    return grads


class FusedTeacherForced(torch.autograd.Function):
    """Kernels 3 and 4 as one differentiable op, wired as the TPU package's
    ``fused_teacher_forced`` custom VJP: the forward keeps the pre-step
    (h, c) residuals, the backward recomputes each step from them."""

    @staticmethod
    def forward(ctx, proj_txt, cmd_mask, proj_vis, h0, c0, tokens, drop,
                num_steps, *weights):
        weights = DecoderWeights(*weights)
        logits, h_res, c_res, asum = teacher_forced_forward(
            proj_txt, cmd_mask, proj_vis, h0, c0, tokens, drop, weights,
            num_steps=num_steps)
        ctx.save_for_backward(proj_txt, cmd_mask, proj_vis, tokens, drop,
                              h_res, c_res, *weights)
        ctx.num_steps = num_steps
        return logits, asum

    @staticmethod
    def backward(ctx, dlogits, g_asum):
        (proj_txt, cmd_mask, proj_vis, tokens, drop, h_res,
         c_res) = ctx.saved_tensors[:7]
        weights = DecoderWeights(*ctx.saved_tensors[7:])
        d_proj_txt, d_proj_vis, dh0, dc0, stash = teacher_forced_backward(
            proj_txt, cmd_mask, proj_vis, tokens, drop, weights, h_res,
            c_res, dlogits.contiguous(), g_asum.contiguous(),
            num_steps=ctx.num_steps)
        d_weights = teacher_forced_weight_grads(stash, h_res,
                                                dlogits.contiguous())
        return (d_proj_txt, None, d_proj_vis, dh0, dc0, None, None, None,
                *d_weights)


def fused_teacher_forced(proj_txt, cmd_mask, proj_vis, h0, c0, tokens, drop,
                         weights: DecoderWeights, *, num_steps: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The teacher-forced unroll through kernels 3 and 4 (their plain twins
    on CPU tensors): (logits [T, B, V], summed visual attention [B, M_v]
    over t < num_steps), differentiable in the keys, h0, c0 and weights."""
    return FusedTeacherForced.apply(proj_txt, cmd_mask, proj_vis, h0, c0,
                                    tokens, drop, num_steps, *weights)
