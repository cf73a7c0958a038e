"""One rank's cases of tests/test_torch_parallel.py (gloo on the CPU).

``run_cases(mesh, payload)`` runs every case of that file on this rank of
a two-rank group started by ``parallel/launch.py`` and saves what it saw
to ``<payload["out_dir"]>/rank<r>.pt``; the test compares the ranks with
each other, with the port's single process and with the JAX package's
2-device mesh. It imports torch, numpy and the port only: each rank is a
spawned process, and JAX has no part in it.
"""

import contextlib
import os

import numpy as np
import torch

from multimodal_seq2seq_gscan_tpu_torch.core.batch import Batch
from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
    GroundedScanDataset)
from multimodal_seq2seq_gscan_tpu_torch.decode.greedy import (
    make_greedy_decoder)
from multimodal_seq2seq_gscan_tpu_torch.decode.predict import (
    evaluate, predict_and_save)
from multimodal_seq2seq_gscan_tpu_torch.models.params import leaves
from multimodal_seq2seq_gscan_tpu_torch.parallel.mesh import (
    make_global_batch, make_mesh, shard_batch, shard_examples_for_process)
from multimodal_seq2seq_gscan_tpu_torch.train.resident import (
    ChunkGraphs, make_train_chunk)
from multimodal_seq2seq_gscan_tpu_torch.train.state import Adam
from multimodal_seq2seq_gscan_tpu_torch.train.step import (
    loss_and_grads, train_step)

# (decode_impl, compute_dtype) of the sharded decodes.
DECODES = (("block_plain", None), ("step", "bfloat16"),
           ("step", "bfloat16_mixed"), ("step", "bfloat16_keys"))


def numpy_state(state):
    """(params, mu, nu) as lists of arrays."""
    return tuple([t.numpy().copy() for t in leaves(tree)] for tree in (
        state.params, state.opt_state.mu, state.opt_state.nu))


def floats(metrics):
    return {name: float(value) for name, value in metrics.items()}


def fixture_dataset(payload):
    data = GroundedScanDataset(payload["fixture_data"],
                               payload["fixture_directory"], split="dev",
                               backend="engine")
    data.read_dataset(max_examples=payload["predict_examples"])
    return data


def run_cases(mesh, payload):
    seen = {}

    # make_mesh refuses shapes that do not cover the two ranks.
    refusals = []
    for shape in ((4, 1), (3, 2), (1, 1), (2, 2)):
        try:
            make_mesh(*shape)
            refusals.append(None)
        except ValueError as error:
            refusals.append(str(error))
    seen["refusals"] = refusals
    replicas = make_mesh(data_parallel=1, model_parallel=2)
    seen["model_axis"] = (replicas.shape, replicas.data_index)

    state, config = payload["state"], payload["config"]
    optimizer = Adam()

    # One sharded step from the JAX state, dropout off.
    new, metrics = train_step(state, shard_batch(mesh, payload["batch"]),
                              config, optimizer, mesh=mesh)
    seen["step"] = (floats(metrics), numpy_state(new))
    # The same step over a model axis of 2 (both ranks hold every row).
    new, metrics = train_step(state, shard_batch(replicas, payload["batch"]),
                              config, optimizer, mesh=replicas)
    seen["step_model_axis"] = (floats(metrics), numpy_state(new))

    # Halves of very different target lengths: loss and gradients.
    loss, _, grads = loss_and_grads(
        state, shard_batch(mesh, payload["skew_batch"]), config, mesh=mesh)
    seen["skew"] = (float(loss), [g.numpy().copy() for g in leaves(grads)])

    # Dropout on: two steps.
    dropout_state = state
    for _ in range(2):
        dropout_state, metrics = train_step(
            dropout_state, shard_batch(mesh, payload["batch"]),
            payload["dropout_config"], optimizer, mesh=mesh)
    seen["dropout"] = (floats(metrics), numpy_state(dropout_state))

    # Resident chunks, full and stratified layouts, dropout on.
    chunk = make_train_chunk(payload["dropout_config"], optimizer, mesh=mesh)
    for name, (block, segments) in payload["blocks"].items():
        chunk_state, chunk_metrics = chunk(state, payload["resident"], block,
                                           segments)
        seen["chunk_" + name] = (
            {k: v.numpy().copy() for k, v in chunk_metrics.items()},
            numpy_state(chunk_state))

    # The key of a chunk's CUDA graph while a profiler runs on rank 0
    # alone, as the loop's ``StepProfiler`` does: the same on both ranks
    # (the data's addresses, which differ by process, left out).
    graphs = ChunkGraphs(payload["dropout_config"], optimizer, 0.3,
                         mesh=mesh)
    profiler = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
        if mesh.rank == 0 else contextlib.nullcontext())
    with profiler:
        key = graphs.key((4,) * 2, 4, payload["resident"])
    seen["graph_key"] = key[:2] + key[3:]

    # The sharded greedy decode of the fixture's examples.
    fixture_config, params = payload["fixture_config"], payload["params"]
    inputs = shard_batch(mesh, payload["decode_inputs"])
    for impl, dtype in DECODES:
        decoder = make_greedy_decoder(fixture_config, 120, decode_impl=impl,
                                      compute_dtype=dtype, mesh=mesh)
        out = decoder(params, *inputs)
        seen["decode_{}".format(dtype or "float32")] = {
            name: getattr(out, name).numpy().copy() for name in (
                "tokens", "lengths", "emitted_mask", "attention_commands",
                "attention_situations", "position_accuracy")}

    # predict.json and evaluate() through the mesh.
    dataset = fixture_dataset(payload)
    predict_and_save(dataset, params, fixture_config,
                     payload["predict_path"], max_decoding_steps=120,
                     batch_size=payload["predict_batch"], mesh=mesh)
    seen["evaluate"] = evaluate(
        dataset, params, fixture_config, 120,
        batch_size=payload["predict_batch"], mesh=mesh)

    # The multi-host mirror: this process loads only its shard of the
    # examples and the shards make the global batch.
    rows = shard_examples_for_process(payload["batch"].input_ids.shape[0])
    local = Batch(*(np.asarray(x)[rows] for x in payload["batch"]))
    global_batch = make_global_batch(mesh, local)
    new, metrics = train_step(state, global_batch, config, optimizer,
                              mesh=mesh)
    seen["multihost"] = (floats(metrics),
                         [float(t.sum()) for t in leaves(new.params)])
    # Over a model axis of 2 the shards are joined and every rank holds
    # all the rows.
    new, metrics = train_step(state, make_global_batch(replicas, local),
                              config, optimizer, mesh=replicas)
    seen["multihost_model_axis"] = (floats(metrics), numpy_state(new))

    torch.save(seen, os.path.join(payload["out_dir"],
                                  "rank{}.pt".format(mesh.rank)))
    return mesh.rank
