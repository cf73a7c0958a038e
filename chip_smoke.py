#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

It builds the port's CUDA kernels from ``multimodal_seq2seq_gscan_tpu_torch/
csrc`` (one ``nvcc`` call into ``build/torch_kernels/``), holds each kernel
against its plain PyTorch version on the card at the shapes of the main path,
then drives the main path: the trained fixture checkpoint
(``data/bench_fixture/model_best.msgpack``) greedily decodes the fixture's
4096 dev examples at batch 4096 (120-step cap, early exit checked every 32
steps), once through kernel 2 (the decode block) and once through its plain
version, and the first 512 examples through the step-by-step decoder, whose
attentions are kernel 1. The kernel paths must give the plain path's tokens
on every example, apart from steps that are argmax near-ties in the plain
path (top-2 logit gap below 1e-4), which are counted and printed. Then it
times each kernel and its plain version with CUDA events, and the full decode.

Every phase prints its wall time. Any failure raises, so the exit code is not
0 and the final line is not printed. The last lines are: the card's name and
power limit as nvidia-smi reports them, a ``kernels:`` summary, one JSON
object describing each kernel (launches on the main path, error against the
plain version, times, bound), and the result line
``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "data" / "bench_fixture"
MAX_DECODING_STEPS = 120
EXIT_CHECK_EVERY = 32
BATCH = 4096
STEP_EXAMPLES = 512
NEAR_TIE = 1e-4
DEVICE = "cuda"

# NVIDIA H100 SXM data sheet, full 700 W power limit: float32 outside the
# tensor cores, and HBM3 bandwidth. A bound is the larger of operations over
# the first and bytes over the second.
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def require(condition, message):
    if not condition:
        raise SmokeFailure(message)


@contextlib.contextmanager
def phase(name):
    start = time.perf_counter()
    print("== {}".format(name), flush=True)
    yield
    print("== {}: {:.2f} s".format(name, time.perf_counter() - start),
          flush=True)


def nvidia_smi_line():
    result = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return result.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats, warmup=2):
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def bound_ms(num_bytes, flops):
    """(least milliseconds the card needs, what bounds it)."""
    by_bytes = num_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def attention_work(batch, m, h, masked):
    """(bytes, flops) of one additive attention call: each input read once,
    each output written once; per (row, key, feature) an add, a tanh and a
    multiply-add for the score and a multiply-add for the context."""
    floats = (batch * h + batch * m * h + (batch * m if masked else 0) + h
              + batch * h + batch * m)
    flops = batch * m * h * 6 + batch * m * 5
    return 4 * floats, flops


def decode_block_work(batch, m_t, m_v, h, vocab, steps, weights_bytes,
                      row_steps):
    """(bytes, flops) of one decode-block launch. Bytes: the keys, mask and
    state read once, the weights once, the state and per-step outputs written
    once. Flops: what the ``row_steps`` emitting row-steps of this launch
    need (a done row's step needs nothing)."""
    read = 4 * (batch * m_t * h + batch * m_t + batch * m_v * h
                + 2 * batch * h + batch) + batch + weights_bytes
    written = (4 * (2 * batch * h + batch + steps * batch * (2 + m_t + m_v))
               + batch)
    products = (h * h + 2 * h * h + h * h + 3 * h * 4 * h + h * 4 * h
                + 4 * h * h + h * vocab)
    per_row_step = 2 * products + (m_t + m_v) * (h * 6 + 5) + 12 * h
    return read + written, row_steps * per_row_step


def divergences(tokens, emitted, ref_tokens, ref_emitted, ref_gap):
    """Rows ([B, S] inputs) whose emitted tokens differ from the plain
    version's, as (row, first differing step, the plain version's top-2
    logit gap at that step)."""
    import torch
    emitted, ref_emitted = emitted > 0, ref_emitted > 0
    differ = ((tokens * emitted) != (ref_tokens * ref_emitted)) \
        | (emitted != ref_emitted)
    found = []
    for row in torch.nonzero(differ.any(dim=1)).flatten().tolist():
        step = int(torch.nonzero(differ[row]).flatten()[0])
        found.append((row, step, float(ref_gap[row, step])))
    return found


def decode_divergences(out, ref, rows):
    """``divergences`` of a greedy decode against the first ``rows`` rows of
    the plain (``block_plain``) decode."""
    return divergences(out.tokens, out.emitted_mask, ref.tokens[:rows],
                       ref.emitted_mask[:rows], ref.top2_gap[:rows])


def check_divergences(label, divergences):
    ties = [d for d in divergences if d[2] < NEAR_TIE]
    faults = [d for d in divergences if d[2] >= NEAR_TIE]
    print("{}: {} rows differ from the plain path, {} at argmax near-ties "
          "(row, step, top-2 gap): {}".format(label, len(divergences),
                                              len(ties), ties[:20]))
    require(not faults, "{}: tokens differ from the plain path away from a "
            "near-tie (row, step, gap): {}".format(label, faults[:20]))
    return len(ties)


def as_float64(args):
    """The same arguments with every float tensor in float64."""
    import torch
    out = []
    for arg in args:
        if isinstance(arg, tuple):
            out.append(type(arg)(*as_float64(arg)))
        elif isinstance(arg, torch.Tensor) and arg.is_floating_point():
            out.append(arg.double())
        else:
            out.append(arg)
    return out


def against_float64(label, kernel, plain, exact):
    """Hold the kernel and the plain float32 version to a float64 evaluation
    of the same function: on the fixture's inputs (visual scores reach ~36)
    float32 rounding alone moves the plain version by about the JAX tests'
    absolute bars, so the kernel must be no further from the float64 value
    than twice the plain version's distance, or within 1e-6."""
    kernel_err = float((kernel.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    print("{}: max |err| vs float64: kernel {:.3e}, plain {:.3e}; kernel vs "
          "plain {:.3e}".format(label, kernel_err, plain_err,
                                float((kernel - plain).abs().max())))
    require(kernel_err <= max(2 * plain_err, 1e-6),
            "{}: the kernel is further from float64 than the plain "
            "version".format(label))


def random_attention_inputs(gen, device, batch, m, h, masked):
    """The JAX attention test's input distribution at the given shape:
    N(0, 1) queries and keys, an N(0, 1/H) energy vector, valid lengths
    uniform in 0..M (0 gives an all-masked row)."""
    import torch
    pq = torch.randn(batch, h, generator=gen, device=device)
    keys = torch.randn(batch, m, h, generator=gen, device=device)
    energy = torch.randn(h, 1, generator=gen, device=device) / h ** 0.5
    mask = None
    if masked:
        lengths = torch.randint(0, m + 1, (batch,), generator=gen,
                                device=device)
        mask = (torch.arange(m, device=device)[None] < lengths[:, None]
                ).float()
    return pq, keys, mask, energy


def random_block_inputs(gen, device, batch, m_t, m_v, h, vocab, sos):
    """Decode-block inputs at the given shape: decoder weights drawn as the
    JAX package initialises them (uniform in +-1/sqrt(fan_in), LSTM
    +-1/sqrt(H), embedding N(0, 1) with the pad row zeroed), N(0, 1) keys,
    command lengths uniform in 1..M_t, h = c = tanh(N(0, 1)), all at SOS."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.ops.decode_block import (
        DecoderWeights)

    def uniform(shape, fan_in):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) \
            * fan_in ** -0.5

    embedding = torch.randn(vocab, h, generator=gen, device=device)
    embedding[0] = 0.0
    weights = DecoderWeights(
        txt_qw=uniform((h, h), h), txt_ew=uniform((h, 1), h),
        q2k_w=uniform((2 * h, h), 2 * h), q2k_b=uniform((1, h), 2 * h),
        vis_qw=uniform((h, h), h), vis_ew=uniform((h, 1), h),
        embedding=embedding, w_ih=uniform((3 * h, 4 * h), h),
        w_hh=uniform((h, 4 * h), h),
        bias=uniform((1, 4 * h), h) + uniform((1, 4 * h), h),
        out_w=uniform((4 * h, h), 4 * h), out_proj=uniform((h, vocab), h))
    lengths = torch.randint(1, m_t + 1, (batch,), generator=gen,
                            device=device)
    mask = (torch.arange(m_t, device=device)[None] < lengths[:, None]).float()
    h0 = torch.tanh(torch.randn(batch, h, generator=gen, device=device))
    return (torch.randn(batch, m_t, h, generator=gen, device=device), mask,
            torch.randn(batch, m_v, h, generator=gen, device=device), h0,
            h0.clone(),
            torch.full((batch,), sos, dtype=torch.int32, device=device),
            torch.zeros((batch,), dtype=torch.bool, device=device), weights)


def block_pair(label, args, eos_idx):
    """One K-step block through the kernel and through the plain version.
    Tokens, emitted flags, carried tokens and done must agree on every row,
    apart from rows that part at an argmax near-tie of the plain version.
    Returns (kernel output, plain output, rows that did not part)."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    out = k2.fused_decode_block(*args, num_steps=EXIT_CHECK_EVERY,
                                eos_idx=eos_idx)
    if out.h.is_cuda:
        torch.cuda.synchronize()
    gaps = []
    ref = k2.decode_block_plain(*args, num_steps=EXIT_CHECK_EVERY,
                                eos_idx=eos_idx, top2_gap=gaps)
    found = divergences(out.step_tokens.T, out.step_emitted.T,
                        ref.step_tokens.T, ref.step_emitted.T,
                        torch.stack(gaps).T)
    check_divergences("{} K={}".format(label, EXIT_CHECK_EVERY), found)
    same = torch.ones_like(out.done)
    same[[row for row, _, _ in found]] = False
    require(torch.equal(out.done[same], ref.done[same])
            and torch.equal(out.tokens[same], ref.tokens[same]),
            "{}: carried tokens or done differ".format(label))
    return out, ref, same


def rows_of(output, name, rows):
    """Field ``name`` of a block output, restricted to batch ``rows``."""
    value = getattr(output, name)
    return value[:, rows] if name.startswith("step_") else value[rows]


def exact_match(output, dataset, indices, eos_idx):
    from multimodal_seq2seq_gscan_tpu_torch.decode.greedy import (
        strip_output_sequences)
    sequences, _ = strip_output_sequences(output, eos_idx)
    matched = sum(seq == dataset.target_ids[int(i)][1:-1].tolist()
                  for seq, i in zip(sequences, indices))
    return 100.0 * matched / len(indices)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
        GroundedScanDataset)
    from multimodal_seq2seq_gscan_tpu_torch.decode import greedy
    from multimodal_seq2seq_gscan_tpu_torch.models import model
    from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
    from multimodal_seq2seq_gscan_tpu_torch.ops import _build
    from multimodal_seq2seq_gscan_tpu_torch.ops import additive_attention as k1
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    from multimodal_seq2seq_gscan_tpu_torch.train.checkpoint import (
        load_params)

    device = torch.device(DEVICE)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    total_start = time.perf_counter()

    with phase("device"):
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = nvidia_smi_line()
        # Full float32: cuDNN would run the encoder's convolutions in TF32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print("torch {} (CUDA {}), python {}".format(
            torch.__version__, torch.version.cuda, sys.version.split()[0]))
        print("device: {} x{}".format(kind, count))
        print(smi)

    with phase("build kernels"):
        _build.library()
        print("library: {}".format(_build.library_path))
        print("build seconds: {:.2f}".format(_build.build_seconds))
        for line in _build.build_log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print("  ptxas: " + line.strip())

    with phase("load fixture"):
        dataset = GroundedScanDataset(str(FIXTURE / "dataset.txt"),
                                      str(FIXTURE), split="dev")
        dataset.read_dataset(max_examples=BATCH)
        config = ModelConfig(
            input_vocabulary_size=dataset.input_vocabulary_size,
            target_vocabulary_size=dataset.target_vocabulary_size,
            num_cnn_channels=dataset.image_channels)
        params = load_params(str(FIXTURE / "model_best.msgpack"),
                             device=device)
        batch, indices = next(dataset.get_data_iterator(
            batch_size=BATCH, pad_to_full_batch=True))
        batch = batch.to(device)
        require(len(indices) == BATCH, "fixture has {} dev examples, "
                "expected {}".format(len(indices), BATCH))
        with torch.no_grad():
            encoded = model.encode_input(params, config, batch.input_ids,
                                         batch.input_lengths,
                                         batch.situations)
            proj_txt, proj_vis = model.project_keys(params, encoded)
            proj_txt, proj_vis = proj_txt.contiguous(), proj_vis.contiguous()
            cmd_mask = encoded.command_mask.contiguous()
            h0, c0 = (s[0].contiguous() for s in
                      model.initialize_decoder_hidden(params, config,
                                                      encoded.hidden))
        weights = k2.pack_decoder_weights(params, config.target_pad_idx)
        m_t, m_v, hidden = proj_txt.shape[1], proj_vis.shape[1], h0.shape[1]
        vocab = weights.embedding.shape[0]
        sos = torch.full((BATCH,), config.target_sos_idx, dtype=torch.int32,
                         device=device)
        not_done = torch.zeros((BATCH,), dtype=torch.bool, device=device)
        print("examples {}, M_t {}, M_v {}, H {}, V {}".format(
            len(indices), m_t, m_v, hidden, vocab))

    with phase("kernels against their plain versions"), torch.no_grad():
        gen = torch.Generator(device=device).manual_seed(0)
        # Kernel 1, (a): the JAX attention test's inputs at a decoder step's
        # two calls (M_t masked, M_v unmasked), with that test's bars.
        attention_err = 0.0
        for m, masked in ((m_t, True), (m_v, False)):
            args = random_attention_inputs(gen, device, BATCH, m, hidden,
                                           masked)
            ctx, w = k1.additive_attention(*args)
            sync()
            ctx_ref, w_ref = k1.additive_attention_plain(*args)
            ctx_err = float((ctx - ctx_ref).abs().max())
            w_err = float((w - w_ref).abs().max())
            print("additive_attention random M={} masked={}: context max "
                  "|err| {:.3e} (atol 1e-5), weights max |err| {:.3e} "
                  "(atol 1e-6)".format(m, masked, ctx_err, w_err))
            require(ctx_err <= 1e-5 and w_err <= 1e-6,
                    "additive_attention kernel disagrees with its plain "
                    "version")
            attention_err = max(attention_err, ctx_err, w_err)

        # Kernel 1, (b): the fixture's inputs of the first decoder step.
        pq_txt = h0 @ weights.txt_qw
        ctx_cmd, _ = k1.additive_attention_plain(pq_txt, proj_txt, cmd_mask,
                                                 weights.txt_ew)
        visual_query = torch.tanh(torch.cat([h0, ctx_cmd], dim=-1)
                                  @ weights.q2k_w + weights.q2k_b)
        pq_vis = (visual_query @ weights.vis_qw).contiguous()
        attention_calls = [(pq_txt, proj_txt, cmd_mask, weights.txt_ew),
                           (pq_vis, proj_vis, None, weights.vis_ew)]
        for args in attention_calls:
            kernel = k1.additive_attention(*args)
            sync()
            plain = k1.additive_attention_plain(*args)
            exact = k1.additive_attention_plain(*as_float64(args))
            for name, got, want, truth in zip(("context", "weights"),
                                              kernel, plain, exact):
                against_float64("additive_attention fixture M={} {}".format(
                    args[1].shape[1], name), got, want, truth)

        # Kernel 2, (a): weights drawn as the JAX package initialises them,
        # one block of K=32 steps from SOS, the JAX decode test's bars (its
        # attention bar applied to the carried h and c as well).
        random_args = random_block_inputs(gen, device, BATCH, m_t, m_v,
                                          hidden, vocab,
                                          config.target_sos_idx)
        out, ref, same = block_pair("decode_block random", random_args,
                                    config.target_eos_idx)
        block_err = 0.0
        for name in ("step_attn_cmd", "step_attn_sit", "h", "c"):
            got, want = rows_of(out, name, same), rows_of(ref, name, same)
            excess = float(((got - want).abs()
                            - (1e-6 + 1e-5 * want.abs())).max())
            err = float((got - want).abs().max())
            print("decode_block random {}: max |err| {:.3e} (rtol 1e-5, "
                  "atol 1e-6)".format(name, err))
            require(excess <= 0, "decode_block {} disagrees with its plain "
                    "version".format(name))
            block_err = max(block_err, err)

        # Kernel 2, (b): the fixture's first block, K=32 steps from SOS.
        block_args = (proj_txt, cmd_mask, proj_vis, h0, c0, sos, not_done,
                      weights)
        out, ref, same = block_pair("decode_block fixture", block_args,
                                    config.target_eos_idx)
        exact = k2.decode_block_plain(*as_float64(block_args),
                                      num_steps=EXIT_CHECK_EVERY,
                                      eos_idx=config.target_eos_idx)
        same &= (exact.step_tokens == ref.step_tokens).all(dim=0)
        for name in ("step_attn_cmd", "step_attn_sit", "h", "c"):
            against_float64("decode_block fixture {}".format(name),
                            rows_of(out, name, same), rows_of(ref, name, same),
                            rows_of(exact, name, same))
        first_block_row_steps = int(ref.step_emitted.sum())

    with phase("main path: decode {} fixture dev examples".format(BATCH)):
        decode_kernel = greedy.make_greedy_decoder(
            config, MAX_DECODING_STEPS, EXIT_CHECK_EVERY, decode_impl="block")
        decode_plain = greedy.make_greedy_decoder(
            config, MAX_DECODING_STEPS, EXIT_CHECK_EVERY,
            decode_impl="block_plain")
        decode_step = greedy.make_greedy_decoder(
            config, MAX_DECODING_STEPS, EXIT_CHECK_EVERY, decode_impl="step")
        inputs = (batch.input_ids, batch.input_lengths, batch.situations,
                  batch.target_positions)

        k1.launches, k2.launches = 0, 0
        kernel_out = decode_kernel(params, *inputs)
        sync()
        launches_block = {"decode_block": k2.launches,
                          "additive_attention": k1.launches}
        plain_out = decode_plain(params, *inputs)
        sync()
        k1.launches, k2.launches = 0, 0
        step_out = decode_step(params, *(x[:STEP_EXAMPLES] for x in inputs))
        sync()
        launches_step = {"decode_block": k2.launches,
                         "additive_attention": k1.launches}
        print("launches, block decode: {}; step decode: {}".format(
            launches_block, launches_step))
        require(launches_block["decode_block"] > 0
                and launches_step["additive_attention"] > 0,
                "a kernel of the main path was not launched")

        for label, output, rows in (("block decode", kernel_out, BATCH),
                                    ("plain decode", plain_out, BATCH),
                                    ("step decode", step_out, STEP_EXAMPLES)):
            shape = tuple(output.tokens.shape)
            require(shape == (rows, MAX_DECODING_STEPS + 1),
                    "{} tokens have shape {}".format(label, shape))
            for name in ("attention_commands", "attention_situations"):
                require(bool(torch.isfinite(getattr(output, name)).all()),
                        "{} {} not finite".format(label, name))
        ties_block = check_divergences(
            "block decode vs plain", decode_divergences(kernel_out, plain_out,
                                                        BATCH))
        ties_step = check_divergences(
            "step decode vs plain (first {})".format(STEP_EXAMPLES),
            decode_divergences(step_out, plain_out, STEP_EXAMPLES))
        eos = config.target_eos_idx
        em_kernel = exact_match(kernel_out, dataset, indices, eos)
        em_plain = exact_match(plain_out, dataset, indices, eos)
        em_step = exact_match(step_out, dataset, indices[:STEP_EXAMPLES], eos)
        em_plain_512 = exact_match(
            greedy.GreedyDecodeOutput(*(x[:STEP_EXAMPLES] for x in plain_out)),
            dataset, indices[:STEP_EXAMPLES], eos)
        print("exact match: block (kernel 2) {:.4f}%, plain {:.4f}% over {}; "
              "step (kernel 1) {:.4f}%, plain {:.4f}% over the first "
              "{}".format(em_kernel, em_plain, BATCH, em_step, em_plain_512,
                          STEP_EXAMPLES))
        require(em_kernel > 90.0, "the trained fixture decodes at only "
                "{:.2f}% exact match".format(em_kernel))
        print("decoded steps: {} of {}; emitted tokens: {}".format(
            int(kernel_out.emitted_mask.sum(0).gt(0).sum()),
            MAX_DECODING_STEPS + 1, int(kernel_out.lengths.sum())))

    with phase("times (CUDA events)"), torch.no_grad():
        def both_attention(fn):
            return lambda: [fn(*args) for args in attention_calls]

        attention_ms = cuda_ms(both_attention(k1.additive_attention), 50)
        attention_plain_ms = cuda_ms(
            both_attention(k1.additive_attention_plain), 20)
        block_ms = cuda_ms(lambda: k2.fused_decode_block(
            *block_args, num_steps=EXIT_CHECK_EVERY,
            eos_idx=config.target_eos_idx), 10)
        block_plain_ms = cuda_ms(lambda: k2.decode_block_plain(
            *block_args, num_steps=EXIT_CHECK_EVERY,
            eos_idx=config.target_eos_idx), 3, warmup=1)
        decode_ms = cuda_ms(lambda: decode_kernel(params, *inputs), 5,
                            warmup=1)
        decode_plain_ms = cuda_ms(lambda: decode_plain(params, *inputs), 2,
                                  warmup=1)

        def encode():
            encoded = model.encode_input(params, config, *inputs[:3])
            model.project_keys(params, encoded)
            model.initialize_decoder_hidden(params, config, encoded.hidden)

        encode_ms = cuda_ms(encode, 5, warmup=1)
        attention_bytes, attention_flops = (
            sum(x) for x in zip(attention_work(BATCH, m_t, hidden, True),
                                attention_work(BATCH, m_v, hidden, False)))
        attention_bound = bound_ms(attention_bytes, attention_flops)
        weights_bytes = sum(w.numel() * 4 for w in weights)
        block_bound = bound_ms(*decode_block_work(
            BATCH, m_t, m_v, hidden, vocab, EXIT_CHECK_EVERY, weights_bytes,
            first_block_row_steps))
        print("additive_attention (M={} masked + M={} unmasked, B={}): "
              "{:.4f} ms, plain {:.4f} ms, bound {:.4f} ms ({})".format(
                  m_t, m_v, BATCH, attention_ms, attention_plain_ms,
                  *attention_bound))
        print("decode_block (K={}, B={}, {} emitting row-steps): {:.4f} ms, "
              "plain {:.4f} ms, bound {:.4f} ms ({})".format(
                  EXIT_CHECK_EVERY, BATCH, first_block_row_steps, block_ms,
                  block_plain_ms, *block_bound))
        print("full decode of {} examples: kernel path {:.3f} ms = {:.1f} "
              "ex/s; plain path {:.3f} ms = {:.1f} ex/s".format(
                  BATCH, decode_ms, BATCH / decode_ms * 1e3, decode_plain_ms,
                  BATCH / decode_plain_ms * 1e3))
        print("of which the encoder (encode_input, project_keys, initial "
              "state): {:.3f} ms; decode blocks run: {}".format(
                  encode_ms, launches_block["decode_block"]))

    kernels = [
        {"name": "additive_attention", "route": "cuda",
         "source": "multimodal_seq2seq_gscan_tpu_torch/csrc/"
                   "additive_attention.cu",
         "replaces": "multimodal_seq2seq_gscan_tpu/ops/pallas_attention.py:55",
         "launches": launches_step["additive_attention"],
         "max_abs_err": attention_err, "ms": attention_ms,
         "plain_ms": attention_plain_ms, "bound_ms": attention_bound[0],
         "bound_by": attention_bound[1], "library_ms": None},
        {"name": "decode_block", "route": "cuda",
         "source": "multimodal_seq2seq_gscan_tpu_torch/csrc/decode_block.cu",
         "replaces": "multimodal_seq2seq_gscan_tpu/ops/pallas_decoder.py:149",
         "launches": launches_block["decode_block"],
         "max_abs_err": block_err, "ms": block_ms,
         "plain_ms": block_plain_ms, "bound_ms": block_bound[0],
         "bound_by": block_bound[1], "library_ms": None},
    ]
    print("near-ties: block decode {}, step decode {}".format(ties_block,
                                                              ties_step))
    print("total wall time: {:.2f} s".format(
        time.perf_counter() - total_start))
    print("kernels: {}".format(json.dumps(
        {k["name"]: k["launches"] for k in kernels})))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
