#!/usr/bin/env python3
"""Time the teacher-forced kernels of one checkout on the card, for A/B runs.

    python3 scripts/torch_kernel_ab.py [--root DIR] [--label NAME]
                                       [--repeats R] [--set NAME=VALUE]
                                       [--hidden H] [--m-v M]
                                       [--end-to-end]
                                       [--wide [--alternative]]
                                       [--teacher-forced
                                        [--hidden-sweep H,H,...]]

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
- ``--teacher-forced`` times, instead of all the above, kernels 3 and 4 at
  the training batch (B = 200, T = 56) and W1-W6 and H = 512 (W4-W6 and
  H512 at M_t = 16, M_v = 36), each with the plan the checkout takes (or
  its refusal: before the grid plans, no cluster plan fit past H ~ 480);
  ``--hidden-sweep 136,168,200`` at those H = E instead (M_t = 16, M_v =
  36).
- ``--wide`` times, instead of all the above, the wide shapes: kernel 2, one
  32-step launch from SOS at B = 1024, M_t = 16, M_v = 36, V = 9 and H = E =
  449, 640 and 1024 (W4-W6), every row emitting at every step (an EOS token
  outside the vocabulary), beside its plain version and its bound, with the
  plan it takes, and at W5 with 90% of the rows done at entry and EOS 2 (a
  decode's second block); and the helper at B = 200, T = 56 and W1-W3 (H =
  E = 100 with a 9x9 grid, 136, 256) and its library call, both replayed
  from CUDA graphs, with the helper's kernels' device times apart
  (``torch.profiler``). ``--alternative`` adds the cluster layout that
  kernel 2 could have taken instead of its grid plan, as kernel 3
  (``forward_cluster_kernel``: 8 CTAs of a cluster each own H / 8 units,
  16 rows a cluster) runs it: one teacher-forced launch of the same step's
  products at W4-W6's shapes (B = 1024, T = 32), beside its bound.

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


WIDE_BATCH, WIDE_M_T, WIDE_M_V, WIDE_VOCAB, SOS, EOS = 1024, 16, 36, 9, 1, 2
WIDE = (("W4", 449), ("W5", 640), ("W6", 1024))
WIDE_HELPER = (("W1", 100, 16, 81), ("W2", 136, 16, 36),
               ("W3", 256, 72, 144))


def wide_times(cs, alternative):
    """Kernel 2 at W4-W6 (and W5 with 90% of the rows done), the helper at
    W1-W3 beside its library call, and with ``alternative`` the cluster
    layout at W4-W6: a list of rows, each printed as it is taken."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from multimodal_seq2seq_gscan_tpu_torch.ops import _build
    from multimodal_seq2seq_gscan_tpu_torch.ops import decode_block as k2
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    device = torch.device("cuda")
    index = _build.device_index(device)
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []

    def keep(row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    # W4-W6 with an EOS token outside the vocabulary: every row emits at
    # every step (the most work a launch can have); W5 with 90% of the rows
    # done at entry and EOS 2.
    cases = [(name, h, 0.0, WIDE_VOCAB) for name, h in WIDE] + [
        ("W5 90% done", 640, 0.9, EOS)]
    for name, h, done, eos in cases:
        block = cs.random_block_inputs(gen, device, WIDE_BATCH, WIDE_M_T,
                                       WIDE_M_V, h, WIDE_VOCAB, SOS,
                                       done_fraction=done)

        def kernel():
            return k2.fused_decode_block(*block, num_steps=32, eos_idx=eos)

        out = kernel()
        bound = cs.bound_ms(*cs.decode_block_work(
            WIDE_BATCH, WIDE_M_T, WIDE_M_V, h, WIDE_VOCAB, 32,
            sum(w.numel() * 4 for w in block[7]),
            int(out.step_emitted.sum())))
        keep(dict(kernel="decode_block", shape=name, h=h,
                  ms=cs.cuda_ms(kernel, 2, warmup=1),
                  plain_ms=cs.cuda_ms(lambda: k2.decode_block_plain(
                      *block, num_steps=32, eos_idx=eos), 1, warmup=1),
                  bound_ms=bound[0], bound_by=bound[1],
                  plan=k2.block_plan(h, WIDE_VOCAB, WIDE_M_T, WIDE_M_V,
                                     index).describe(),
                  row_steps=int(out.step_emitted.sum())))
        del block, out
    for name, h, m_t, m_v in WIDE_HELPER:
        steps = cs.TRAIN_T - 3
        inputs, (dlogits, g_asum) = cs.random_teacher_forced_inputs(
            gen, device, cs.TRAIN_BATCH, cs.TRAIN_T, steps, m_t, m_v, h,
            WIDE_VOCAB, SOS)
        _, h_res, c_res, _ = tf.teacher_forced_forward(*inputs,
                                                       num_steps=steps)
        stash = tf.teacher_forced_backward(
            *inputs[:3], *inputs[5:], h_res, c_res, dlogits, g_asum,
            num_steps=steps)[4]
        operands = cs.helper_library_operands(
            stash, h_res, dlogits, inputs[7].embedding.shape[1])

        def helper():
            return tf.teacher_forced_weight_grads(stash, h_res, dlogits)

        first = cs.graph_ms(helper, 20)
        library = cs.graph_ms(lambda: cs.helper_library(operands), 20)
        again = cs.graph_ms(helper, 20)
        bound = cs.bound_ms(*cs.teacher_forced_work(
            cs.TRAIN_BATCH, cs.TRAIN_T, m_t, m_v, h, h, WIDE_VOCAB)[2])
        # The helper's kernels apart: device time a call, by name.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                helper()
            torch.cuda.synchronize()
        keep(dict(kernel="teacher_forced_weight_grads", shape=name, h=h,
                  helper_graph_ms=[first, again], library_graph_ms=library,
                  bound_ms=bound[0],
                  kernels_ms={e.key: e.device_time_total / 5e3
                              for e in prof.key_averages()
                              if e.device_time_total > 0}))
        del inputs, dlogits, g_asum, h_res, c_res, stash, operands
    for name, h in (reversed(WIDE) if alternative else ()):
        steps = 32
        row = dict(kernel="teacher_forced_forward (the cluster layout)",
                   shape=name, h=h)
        try:
            plan = tf.shared_memory_plan("teacher_forced_forward", WIDE_M_T,
                                         WIDE_M_V, h, h, WIDE_VOCAB, index)
        except ValueError as refused:  # its shared memory does not fit
            row.update(refused=str(refused))
        else:
            if plan[1].startswith("grid"):  # no cluster plan fits
                row.update(refused="no cluster plan fits: " + str(plan))
                keep(row)
                continue
            inputs, _ = cs.random_teacher_forced_inputs(
                gen, device, WIDE_BATCH, steps, steps, WIDE_M_T, WIDE_M_V,
                h, WIDE_VOCAB, SOS)
            bound = cs.bound_ms(*cs.teacher_forced_work(
                WIDE_BATCH, steps, WIDE_M_T, WIDE_M_V, h, h, WIDE_VOCAB)[0])
            row.update(batch=WIDE_BATCH, steps=steps, plan=str(plan),
                       ms=cs.cuda_ms(lambda: tf.teacher_forced_forward(
                           *inputs, num_steps=steps), 2, warmup=1),
                       bound_ms=bound[0], bound_by=bound[1])
            del inputs
        keep(row)
    return rows


# Kernels 3 and 4 at the training batch: (name, H = E, M_t, M_v).
TEACHER_FORCED = (("W1", 100, 16, 81), ("W2", 136, 16, 36),
                  ("W3", 256, 72, 144), ("W4", 449, 16, 36),
                  ("H512", 512, 16, 36), ("W5", 640, 16, 36),
                  ("W6", 1024, 16, 36))


def teacher_forced_times(cs, repeats, shapes=TEACHER_FORCED):
    """Kernels 3 and 4 at ``shapes`` (TEACHER_FORCED; B = 200, T = 56,
    num_steps = 53,
    V = 9; random inputs drawn as chip_smoke.py draws them, seed 0), each
    with the plan the checkout takes and its bound; a shape the checkout's
    kernels refuse gives its ValueError instead. A list of rows, each
    printed as it is taken."""
    import torch
    from multimodal_seq2seq_gscan_tpu_torch.ops import _build
    from multimodal_seq2seq_gscan_tpu_torch.ops import teacher_forced as tf
    device = torch.device("cuda")
    index = _build.device_index(device)
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    steps, num_steps = cs.TRAIN_T, cs.TRAIN_T - 3
    for name, h, m_t, m_v in shapes:
        inputs, (dlogits, g_asum) = cs.random_teacher_forced_inputs(
            gen, device, cs.TRAIN_BATCH, steps, num_steps, m_t, m_v, h,
            WIDE_VOCAB, SOS)
        work = cs.teacher_forced_work(cs.TRAIN_BATCH, steps, m_t, m_v, h, h,
                                      WIDE_VOCAB)
        for number, kernel in enumerate(("teacher_forced_forward",
                                         "teacher_forced_backward")):
            row = dict(kernel=kernel, shape=name, h=h)
            bound = cs.bound_ms(*work[number])
            row.update(bound_ms=bound[0], bound_by=bound[1])
            try:
                row["plan"] = str(tf.shared_memory_plan(
                    kernel, m_t, m_v, h, h, WIDE_VOCAB, index))
            except ValueError as refused:
                row["refused"] = str(refused)
                print(json.dumps(row), flush=True)
                rows.append(row)
                continue
            if number == 0:
                row["ms"] = cs.cuda_ms(lambda: tf.teacher_forced_forward(
                    *inputs, num_steps=num_steps), repeats)
            else:
                # The residuals from the plain forward, also where the
                # checkout's kernel 3 refuses the shapes.
                _, h_res, c_res, _ = tf.teacher_forced_forward_plain(
                    *inputs, num_steps=num_steps)
                row["ms"] = cs.cuda_ms(lambda: tf.teacher_forced_backward(
                    *inputs[:3], *inputs[5:], h_res, c_res, dlogits, g_asum,
                    num_steps=num_steps), repeats)
                del h_res, c_res
            print(json.dumps(row), flush=True)
            rows.append(row)
        del inputs, dlogits, g_asum
        torch.cuda.empty_cache()
    return rows


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
    parser.add_argument("--wide", action="store_true",
                        help="time kernel 2 and the helper at the wide "
                             "shapes only")
    parser.add_argument("--teacher-forced", action="store_true",
                        help="time kernels 3 and 4 at W1-W6 and H = 512 "
                             "only")
    parser.add_argument("--hidden-sweep", default="",
                        help="with --teacher-forced: these H = E (comma "
                             "separated) at M_t = 16, M_v = 36 instead")
    parser.add_argument("--alternative", action="store_true",
                        help="with --wide: also the cluster layout")
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
    if args.teacher_forced:
        with torch.no_grad(), full_float32():
            shapes = tuple(("H{}".format(h), int(h), 16, 36) for h in
                           args.hidden_sweep.split(",") if h) \
                or TEACHER_FORCED
            rows = teacher_forced_times(cs, max(2, args.repeats // 4),
                                        shapes)
        print(json.dumps(dict(label=args.label, package=str(root),
                              sets=args.set, card=card(),
                              teacher_forced=rows)))
        return 0
    if args.wide:
        with torch.no_grad(), full_float32():
            rows = wide_times(cs, args.alternative)
        print(json.dumps(dict(label=args.label, package=str(root),
                              sets=args.set, card=card(), wide=rows)))
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
