#!/usr/bin/env python3
"""Time the teacher-forced kernels of one checkout on the card, for A/B runs.

    python3 scripts/torch_kernel_ab.py [--root DIR] [--label NAME]
                                       [--repeats R] [--set NAME=VALUE]
                                       [--hidden H] [--m-v M]
                                       [--end-to-end]

Imports ``multimodal_seq2seq_gscan_tpu_torch`` from DIR (default: this
checkout), builds DIR's kernels, and times with CUDA events, at the training
main path's shapes (B=200, T=56, num_steps=53, M_t=16, M_v=36, H=E=100, V=9;
random inputs drawn as ``chip_smoke.py`` draws them, seed 0): kernel 3,
kernel 4 and the weight-gradient helper; the helper and its library call
(its 14 products as ``torch.matmul`` on staged operands) also as CUDA
graphs; and, at the decode's batch of 4096, kernel 1 (a decoder step's two
calls), one 32-step launch of kernel 2 from SOS on random inputs, and
kernel 2 on the fixture's two blocks (``chip_smoke.fixture_blocks``: from
SOS, and from the state after the first, most rows done); where the
checkout has it, kernel 1's bf16 form on the same two calls with bf16 keys
(float32, then bf16 queries, energy vector and mask). The measuring
code is this checkout's ``chip_smoke.py``, so two checkouts are timed the
same way.

- ``--set NAME=VALUE`` (repeatable) builds a variant: DIR's package is
  copied to ``build/variants/LABEL/`` and each ``constexpr int NAME = ...;``
  of its CUDA sources is set to VALUE (for example ``kClusterThreads=256``
  or ``kHelperMinBlocks=2``).
- ``--build-only`` builds and stops; a later run of the same checkout or
  variant (same ``--label`` and ``--set``) reuses the build, so several
  can build at once before they are timed in turns.
- ``--hidden`` and ``--m-v`` change H (= E) and M_v. Where a kernel does not
  take the shapes, its plain version is timed instead (the cost of the plain
  path at those shapes).
- ``--end-to-end`` also times one fused training step at batch 200 from the
  fixture's checkpoint and the block decode of the fixture's 4096 dev
  examples, as ``chip_smoke.py`` does, and prints the decode's profile
  (``chip_smoke.profile_decode``: device busy share, kernel 2's and the
  encoder's device time); the resident trainer's graphed chunk of
  ``RESIDENT_K`` steps from the same checkpoint at batch 200, a step; and
  the streamed ``train()`` (``steps_per_execution=1``) from the same
  checkpoint at batch 200, by the wall clock between its loss reports
  (batching, any prefetch, the step and the report included).

Prints one JSON line, with the card's name and power limit. Compare two
checkouts in one call, one process each, in turns: parent, change, change,
parent (see PERF.md).
"""

import argparse
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
PACKAGE = "multimodal_seq2seq_gscan_tpu_torch"
SHAPES = dict(batch=200, steps=56, num_steps=53, m_t=16, m_v=36, hidden=100,
              vocab=9)


def apply_patch(text, patch):
    """``text`` with a unified diff of one file applied: each hunk's old
    lines must occur exactly once."""
    hunks = re.split(r"^@@[^\n]*@@[^\n]*\n", patch, flags=re.M)[1:]
    for hunk in hunks:
        old, new = [], []
        for line in hunk.splitlines(keepends=True):
            tag, body = line[:1], line[1:]
            if tag in (" ", "-"):
                old.append(body)
            if tag in (" ", "+"):
                new.append(body)
        old, new = "".join(old), "".join(new)
        if text.count(old) != 1:
            raise ValueError("a hunk of the patch does not apply:\n" + old)
        text = text.replace(old, new)
    return text


def variant_checkout(root, label, sets=(), patch=None):
    """A copy of ``root``'s package under ``build/variants/label`` with its
    CUDA constants set (``NAME=VALUE``) and a patch of
    ``csrc/teacher_forced.cu`` applied; returns the copy's root."""
    dest = HERE / "build" / "variants" / label
    if (dest / PACKAGE).exists():  # its build/ stays: named by the sources
        shutil.rmtree(dest / PACKAGE)
    shutil.copytree(Path(root) / PACKAGE, dest / PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for assignment in sets:
        name, value = assignment.split("=")
        pattern = r"constexpr int {} = \d+;".format(re.escape(name))
        hits = [path for path in (dest / PACKAGE / "csrc").glob("*.cu*")
                if re.search(pattern, path.read_text())]
        if len(hits) != 1:
            raise ValueError("{} is not one constexpr int of the CUDA "
                             "sources".format(name))
        hits[0].write_text(re.sub(pattern, "constexpr int {} = {};".format(
            name, int(value)), hits[0].read_text()))
    if patch is not None:
        source = dest / PACKAGE / "csrc" / "teacher_forced.cu"
        source.write_text(apply_patch(source.read_text(),
                                      Path(patch).read_text()))
    return dest


def load_chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module (its measuring code)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def kernel_times(cs, s, repeats):
    """Milliseconds of kernels 3, 4 and the helper at shapes ``s`` (the
    plain version where a kernel does not take them)."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    inputs, (dlogits, g_asum) = cs.random_teacher_forced_inputs(
        gen, device, s["batch"], s["steps"], s["num_steps"], s["m_t"],
        s["m_v"], s["hidden"], s["vocab"], 1)
    num_steps = s["num_steps"]
    refused = {}
    if hasattr(tf, "kernel_limit"):
        for name in ("teacher_forced_forward", "teacher_forced_backward"):
            reason = tf.kernel_limit(name, s["m_t"], s["m_v"], s["hidden"],
                                     s["hidden"], s["vocab"])
            if reason is not None:
                refused[name] = reason
    forward = (tf.teacher_forced_forward_plain
               if "teacher_forced_forward" in refused
               else tf.teacher_forced_forward)
    backward = (tf.teacher_forced_backward_plain
                if "teacher_forced_backward" in refused
                else tf.teacher_forced_backward)
    _, h_res, c_res, _ = forward(*inputs, num_steps=num_steps)
    stash = backward(*inputs[:3], *inputs[5:], h_res, c_res, dlogits,
                     g_asum, num_steps=num_steps)[4]
    operands = cs.helper_library_operands(stash, h_res, dlogits,
                                          s["hidden"])
    plain_repeats = max(1, repeats // 10)
    return dict(
        refused=refused,
        forward_ms=cs.cuda_ms(lambda: forward(*inputs, num_steps=num_steps),
                              plain_repeats if refused else repeats),
        backward_ms=cs.cuda_ms(lambda: backward(
            *inputs[:3], *inputs[5:], h_res, c_res, dlogits, g_asum,
            num_steps=num_steps), plain_repeats if refused else repeats),
        helper_ms=cs.cuda_ms(lambda: tf.teacher_forced_weight_grads(
            stash, h_res, dlogits), repeats),
        helper_graph_ms=cs.graph_ms(lambda: tf.teacher_forced_weight_grads(
            stash, h_res, dlogits), repeats),
        helper_library_graph_ms=cs.graph_ms(
            lambda: cs.helper_library(operands), repeats),
        helper_plain_ms=cs.cuda_ms(lambda: tf.weight_grads_plain(
            stash, h_res, dlogits), repeats))


def decode_kernel_times(cs, s, repeats):
    """Milliseconds of kernel 1 (a decoder step's two calls: M_t masked and
    M_v unmasked; launched from the host, as ``chip_smoke.py``'s ``ms``,
    and replayed from a CUDA graph)
    and of one kernel-2 block of 32 steps from SOS, at the decode main
    path's batch of 4096 (random inputs as ``chip_smoke.py`` draws them,
    seed 0)."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.ops import additive_attention
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    calls = [cs.random_attention_inputs(gen, device, cs.BATCH, m, s["hidden"],
                                        masked)
             for m, masked in ((s["m_t"], True), (s["m_v"], False))]
    block_args = cs.random_block_inputs(gen, device, cs.BATCH, s["m_t"],
                                        s["m_v"], s["hidden"], s["vocab"], 1)
    def attention(calls=calls):
        return [additive_attention.additive_attention(*args)
                for args in calls]

    times = dict(
        attention_ms=cs.cuda_ms(attention, repeats * 5),
        attention_graph_ms=cs.graph_ms(attention, repeats * 5),
        block_ms=cs.cuda_ms(lambda: decode_block.fused_decode_block(
            *block_args, num_steps=cs.EXIT_CHECK_EVERY, eos_idx=2),
            max(1, repeats // 2)))
    if hasattr(additive_attention, "launches_bf16"):
        # Kernel 1's bf16 form on the same calls, the keys in bf16: with
        # float32 queries, energy vector and mask (``bfloat16_keys``) and
        # with all of them in bf16 (``bfloat16``).
        for name, small in (("bf16", torch.float32),
                            ("bf16_small", torch.bfloat16)):
            bf16 = [(pq.to(small), keys.to(torch.bfloat16),
                     None if mask is None else mask.to(small),
                     energy.to(small)) for pq, keys, mask, energy in calls]
            times["attention_{}_ms".format(name)] = cs.cuda_ms(
                lambda: attention(bf16), repeats * 5)
            times["attention_{}_graph_ms".format(name)] = cs.graph_ms(
                lambda: attention(bf16), repeats * 5)
    return times


def fixture(cs):
    """(params, config, the first 4096 dev examples as one batch, the train
    split) of the fixture, on the card."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
        GroundedScanDataset)
    from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
    from multimodal_seq2seq_gscan_tpu_torch.train.checkpoint import (
        load_checkpoint)
    device = torch.device("cuda")
    data = str(cs.FIXTURE / "dataset.txt")
    train_set = GroundedScanDataset(data, str(cs.FIXTURE), split="train")
    train_set.read_dataset()
    dev_set = GroundedScanDataset(data, str(cs.FIXTURE), split="dev")
    dev_set.read_dataset(max_examples=cs.BATCH)
    config = ModelConfig(
        input_vocabulary_size=train_set.input_vocabulary_size,
        target_vocabulary_size=train_set.target_vocabulary_size,
        num_cnn_channels=train_set.image_channels,
        input_padding_idx=train_set.input_vocabulary.pad_idx,
        target_pad_idx=train_set.target_vocabulary.pad_idx,
        target_sos_idx=train_set.target_vocabulary.sos_idx,
        target_eos_idx=train_set.target_vocabulary.eos_idx)
    state, _ = load_checkpoint(str(cs.FIXTURE / "model_best.msgpack"),
                               device=device)
    dev_batch = next(dev_set.get_data_iterator(batch_size=cs.BATCH,
                                               pad_to_full_batch=True))[0]
    return state, config, dev_batch.to(device), train_set


def fixture_block_times(cs, fix, repeats):
    """Milliseconds of kernel 2 on the fixture's two decode blocks (from
    SOS, and from the plain version's state after the first)."""
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block
    state, config, dev_batch, _ = fix
    blocks = cs.fixture_blocks(state.params, config, dev_batch)
    return {"fixture_block{}_ms".format(i + 1): cs.cuda_ms(
        lambda: decode_block.fused_decode_block(
            *args, num_steps=cs.EXIT_CHECK_EVERY,
            eos_idx=config.target_eos_idx), max(1, repeats // 2))
        for i, args in enumerate(blocks)}


def end_to_end_times(cs, fix, repeats):
    """Milliseconds of one fused training step (batch 200, from the
    fixture's checkpoint), of a step of the resident trainer's graphed
    chunk, and of the block decode of 4096 dev examples, and the decode's
    profile (printed)."""
    import numpy as np
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.decode import greedy
    from multimodal_seq2seq_gscan_tpu_torch.models import model
    from multimodal_seq2seq_gscan_tpu_torch.train import resident
    from multimodal_seq2seq_gscan_tpu_torch.train.loop import epoch_stream
    from multimodal_seq2seq_gscan_tpu_torch.train.state import Adam
    from multimodal_seq2seq_gscan_tpu_torch.train.step import train_step
    device = torch.device("cuda")
    state, config, dev_batch, train_set = fix
    batch = next(epoch_stream(train_set, cs.TRAIN_BATCH,
                              np.random.default_rng(cs.SEED)))[0].to(device)
    optimizer = Adam()
    step_ms = cs.cuda_ms(lambda: train_step(state, batch, config, optimizer),
                         repeats, warmup=2)
    data = resident.build_resident_data(train_set, device)
    block = next(resident.index_block_stream(
        data.num_examples, cs.TRAIN_BATCH, cs.RESIDENT_K,
        np.random.default_rng(cs.SEED)))
    chunk = resident.make_train_chunk(config, optimizer)
    chunk_ms = cs.cuda_ms(lambda: chunk(state, data, block),
                          max(1, repeats // 2), warmup=1) / cs.RESIDENT_K
    decode = greedy.make_greedy_decoder(config, cs.MAX_DECODING_STEPS,
                                        cs.EXIT_CHECK_EVERY,
                                        decode_impl="block")
    inputs = (dev_batch.input_ids, dev_batch.input_lengths,
              dev_batch.situations, dev_batch.target_positions)

    def encode():
        encoded = model.encode_input(state.params, config, *inputs[:3])
        model.project_keys(state.params, encoded)
        model.initialize_decoder_hidden(state.params, config,
                                        encoded.hidden)

    with torch.no_grad():
        decode_ms = cs.cuda_ms(lambda: decode(state.params, *inputs),
                               max(1, repeats // 2), warmup=1)
        cs.profile_decode(lambda: decode(state.params, *inputs), encode,
                          torch.cuda.synchronize)
    return dict(train_step_ms=step_ms, train_step_t=batch.target_ids.shape[1],
                resident_chunk_step_ms=chunk_ms, decode_ms=decode_ms,
                streamed_train_ms=streamed_train_ms(cs))


def streamed_train_ms(cs, steps=60, every=10):
    """Wall milliseconds a step of the streamed ``train()`` at batch
    TRAIN_BATCH from the fixture's checkpoint: the time from its first loss
    report to its last over the steps between them (no evaluation falls in
    between; the first ``every`` steps, which warm up, fall before)."""
    import tempfile
    import time
    from multimodal_seq2seq_gscan_tpu_torch.train.loop import train
    start, stamps = 200000, []

    def report(kind, iteration, values):
        if kind == "train":
            stamps.append((iteration, time.perf_counter()))

    with tempfile.TemporaryDirectory(prefix="gscan_ab_") as out_dir:
        train(str(cs.FIXTURE / "dataset.txt"), str(cs.FIXTURE),
              training_batch_size=cs.TRAIN_BATCH,
              resume_from_file=str(cs.FIXTURE / "model_best.msgpack"),
              max_training_iterations=start + steps,
              print_every=every, evaluate_every=start + 10 * steps,
              output_directory=out_dir, max_testing_examples=cs.STEP_EXAMPLES,
              seed=cs.SEED, steps_per_execution=1, callback=report)
    (first, t0), (last, t1) = stamps[0], stamps[-1]
    return (t1 - t0) * 1e3 / (last - first)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--label", default="")
    parser.add_argument("--repeats", type=int, default=20)
    parser.add_argument("--set", action="append", default=[])
    parser.add_argument("--hidden", type=int, default=SHAPES["hidden"])
    parser.add_argument("--m-v", type=int, default=SHAPES["m_v"])
    parser.add_argument("--end-to-end", action="store_true")
    parser.add_argument("--build-only", action="store_true",
                        help="build the checkout's (or variant's) kernels "
                             "and stop, so that several build at once")
    args = parser.parse_args()
    root = Path(args.root).resolve()
    if args.set:
        root = variant_checkout(root, args.label or "variant", args.set)
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    from multimodal_seq2seq_gscan_tpu_torch.ops import _build
    from multimodal_seq2seq_gscan_tpu_torch.utils.precision import (
        full_float32)
    _build.library()
    if args.build_only:
        print("{}: built in {:.1f} s".format(args.label or root,
                                             _build.build_seconds))
        for line in _build.build_log.splitlines():
            if any(word in line for word in ("compiled in", "Compiling entry",
                                             "spill", "registers")):
                print("  " + line.strip()[:150])
        return 0
    shapes = dict(SHAPES, hidden=args.hidden, m_v=args.m_v)
    fix = fixture(cs)
    with torch.no_grad(), full_float32():
        times = kernel_times(cs, shapes, args.repeats)
        times.update(decode_kernel_times(cs, shapes, args.repeats))
        times.update(fixture_block_times(cs, fix, args.repeats))
    if args.end_to_end:
        times.update(end_to_end_times(cs, fix, args.repeats // 2))
    print(json.dumps(dict(label=args.label, package=str(root), sets=args.set,
                          shapes=shapes, card=card(), **times)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
