"""The plain reference of the gSCAN multimodal seq2seq model, in float32.

Written from the model's description (Ruis et al. 2020, arXiv 2003.05161,
and the reference code's ``seq2seq_model.py``): a situation CNN of three
parallel same-padding convolutions (kernel sizes 1, 5 and K) with ReLU, a
bidirectional LSTM over the command whose two directions are summed (the
backward direction runs over each row's valid prefix reversed, packed
sequences' semantics), a decoder state of tanh(W h + b), and an LSTM
decoder with two Bahdanau attentions: over the command's projected keys
(masked), then over the grid's, queried by tanh(W [h; context] + b)
(conditional attention). The projected keys are also the attention's
values. The head maps [embedding; h; both contexts] to H and then to the
vocabulary, without biases. Weights take the JAX package's names and
layouts (a dict of tensors, ``benchmark/harness/weights.py``).

Dropout masks are drawn as the program draws them (``torch.rand`` from a
generator of the step's seed, in the order CNN features, command
embedding, decoder token embedding), so that both sides see the same
masks; the seed rule is ``benchmark/reference/train.py::step_seed``.

``Arithmetic`` computes every product in float32 with TF32 off, or, for
the control, with its operands (and the gradients that flow back into
them) rounded to TF32's 10-bit mantissa, as TF32 tensor cores take them.

Imports torch alone: nothing of the program, of the JAX package or of the
benchmark's harness.
"""

import contextlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

PAD, SOS, EOS = 0, 1, 2


@contextlib.contextmanager
def full_float32():
    """TF32 off for matmuls and cuDNN inside the block (cuDNN's default
    lets convolutions run in TF32); the flags restored after it."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest even)."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32).view(x.shape)


class _RoundTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_tf32(x)

    @staticmethod
    def backward(ctx, grad):
        return _round_tf32(grad)


class Arithmetic:
    """Products in float32 (``tf32=False``) or in TF32 (the control)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundTF32.apply(x) if self.tf32 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.operand(a) @ self.operand(b)

    def conv(self, x, w, b, padding):
        return F.conv2d(self.operand(x), self.operand(w), b, padding=padding)


class Encoded(NamedTuple):
    keys_txt: torch.Tensor   # [B, M_t, H] projected command keys
    cmd_mask: torch.Tensor   # [B, M_t] 1.0 on valid tokens
    keys_vis: torch.Tensor   # [B, M_v, H] projected grid keys
    h0: torch.Tensor         # [B, H]


def _dropout(x, rate, generator):
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _reverse(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each row's valid prefix reversed: [a b c 0 0] -> [c b a 0 0]."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    index = lengths.long()[:, None] - 1 - positions
    index = torch.where(index >= 0, index, positions)
    return torch.gather(x, 1, index[..., None].expand_as(x))


def _lstm_cell(A, W, prefix, x, h, c):
    gates = (A.mm(x, W[prefix + ".w_ih"].T) + A.mm(h, W[prefix + ".w_hh"].T)
             + W[prefix + ".b_ih"] + W[prefix + ".b_hh"])
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _lstm_scan(A, W, prefix, x, mask):
    """Outputs (zero at padding) and the state at each row's last token."""
    rows, steps = x.shape[:2]
    hidden = W[prefix + ".w_hh"].shape[1]
    h = x.new_zeros((rows, hidden))
    c = x.new_zeros((rows, hidden))
    outputs = []
    for t in range(steps):
        h_new, c_new = _lstm_cell(A, W, prefix, x[:, t], h, c)
        m = mask[:, t, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        outputs.append(h_new * m)
    return torch.stack(outputs, dim=1), h


def encode(A: Arithmetic, W: Dict[str, torch.Tensor], cfg: dict,
           input_ids, input_lengths, situations,
           generator: Optional[torch.Generator] = None) -> Encoded:
    """The encoder for a batch; dropout when a ``generator`` is given."""
    x = situations.float().permute(0, 3, 1, 2)
    k = cfg["cnn_kernel_size"]
    features = torch.cat([
        A.conv(x, W["cnn.{}_w".format(name)].permute(3, 2, 0, 1),
               W["cnn.{}_b".format(name)], size // 2)
        for name, size in (("conv1", 1), ("conv5", 5), ("convk", k))], dim=1)
    rows, channels = features.shape[:2]
    features = torch.relu(features.permute(0, 2, 3, 1).reshape(
        rows, -1, channels))
    ids = input_ids.long()
    embedded = W["encoder.embedding"][ids] * (ids != PAD)[..., None].float()
    if generator is not None:
        features = _dropout(features, cfg["cnn_dropout_p"], generator)
        embedded = _dropout(embedded, cfg["encoder_dropout_p"], generator)
    mask = (torch.arange(ids.shape[1], device=ids.device)[None, :]
            < input_lengths.long()[:, None]).float()
    fwd_out, fwd_h = _lstm_scan(A, W, "encoder.fwd_layers.0", embedded, mask)
    bwd_rev, bwd_h = _lstm_scan(A, W, "encoder.bwd_layers.0",
                                _reverse(embedded, input_lengths), mask)
    outputs = fwd_out + _reverse(bwd_rev, input_lengths)
    hidden = fwd_h + bwd_h
    return Encoded(
        keys_txt=A.mm(outputs, W["textual_attention.key_w"]),
        cmd_mask=mask,
        keys_vis=A.mm(features, W["visual_attention.key_w"]),
        h0=torch.tanh(A.mm(hidden, W["enc_to_dec_w"]) + W["enc_to_dec_b"]))


def attend(A, queries, keys, mask, energy_w):
    """(context [B, H], weights [B, M]) of Bahdanau attention over
    projected keys that are also the values."""
    scores = A.mm(torch.tanh(queries[:, None, :] + keys), energy_w)[..., 0]
    if mask is not None:
        scores = scores.masked_fill(~(mask > 0), -1e9)
    weights = torch.softmax(scores, dim=-1)
    return A.mm(weights[:, None, :], keys)[:, 0], weights


class Step(NamedTuple):
    logits: torch.Tensor
    h: torch.Tensor
    c: torch.Tensor
    attn_cmd: torch.Tensor
    attn_sit: torch.Tensor


def decoder_step(A, W, enc: Encoded, tokens, h, c,
                 drop: Optional[torch.Tensor] = None) -> Step:
    """One decoder step from the previous token and state."""
    ids = tokens.long()
    embedded = W["decoder.embedding"][ids] * (ids != PAD)[:, None].float()
    if drop is not None:
        embedded = embedded * drop
    ctx_cmd, attn_cmd = attend(A, A.mm(h, W["textual_attention.query_w"]),
                               enc.keys_txt, enc.cmd_mask,
                               W["textual_attention.energy_w"])
    visual_query = torch.tanh(
        A.mm(torch.cat([h, ctx_cmd], dim=-1), W["decoder.queries_to_keys_w"])
        + W["decoder.queries_to_keys_b"])
    ctx_sit, attn_sit = attend(
        A, A.mm(visual_query, W["visual_attention.query_w"]), enc.keys_vis,
        None, W["visual_attention.energy_w"])
    h_new, c_new = _lstm_cell(A, W, "decoder.lstm_layers.0",
                              torch.cat([embedded, ctx_cmd, ctx_sit], -1),
                              h, c)
    hidden = A.mm(torch.cat([embedded, h_new, ctx_cmd, ctx_sit], dim=-1),
                  W["decoder.output_to_hidden_w"])
    logits = A.mm(hidden, W["decoder.hidden_to_output_w"])
    return Step(logits, h_new, c_new, attn_cmd, attn_sit)


def training_loss(A: Arithmetic, W: Dict[str, torch.Tensor], cfg: dict,
                  batch: Tuple[torch.Tensor, ...],
                  generator: torch.Generator) -> torch.Tensor:
    """The teacher-forced loss of one training batch with dropout: the
    mean negative log-likelihood of every target token after SOS."""
    input_ids, input_lengths, situations, target_ids = batch[:4]
    enc = encode(A, W, cfg, input_ids, input_lengths, situations, generator)
    rows, steps = target_ids.shape
    width = W["decoder.embedding"].shape[1]
    keep = 1.0 - cfg["decoder_dropout_p"]
    drop = (torch.rand((steps, rows, width), generator=generator,
                       device=target_ids.device) < keep).float() / keep
    h, c = enc.h0, enc.h0
    logits = []
    for t in range(steps):
        step = decoder_step(A, W, enc, target_ids[:, t], h, c, drop[t])
        h, c = step.h, step.c
        logits.append(step.logits)
    log_probs = torch.log_softmax(torch.stack(logits, dim=1), dim=-1)
    targets = torch.cat([target_ids[:, 1:],
                         torch.zeros_like(target_ids[:, :1])], 1).long()
    picked = torch.gather(log_probs, -1, targets[..., None])[..., 0]
    mask = (targets != PAD).float()
    return -(picked * mask).sum() / torch.clamp(mask.sum(), min=1.0)
