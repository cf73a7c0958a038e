"""The port's data parallelism (``parallel/``) on two gloo ranks on the CPU,
against the port's single process and the JAX package's 2-device mesh.

One two-rank group (``parallel/launch.py``) runs every case
(tests/torch_parallel_worker.py) and saves what each rank saw; the tests
below compare. The ranks must agree with each other bit for bit.

- ``make_mesh`` refuses a shape that does not cover the ranks, as JAX's
  does (tests/test_graft_entry.py); a model axis replicates.
- The sharded step from a JAX state (dropout off) equals JAX's
  ``make_train_step(mesh=)`` on 2 devices: loss atol 1e-5, params, mu and
  nu element by element at rtol 1e-4 / atol 1e-5
  (tests/test_multihost.py's bars); over a model axis of 2 (rows from
  ``shard_batch`` or joined by ``make_global_batch``) it is the single
  process's step bit for bit.
- Halves of very different target lengths: the loss and gradients are
  the global batch's (JAX's single process at the same bars), and a mean
  of per-rank means misses that bar.
- With dropout on, two ranks' steps equal the port's single process, and
  so do the resident chunks, full and stratified.
- The sharded decode of the fixture's first 32 dev examples equals the
  single process's (every output, bit for bit) for ``block_plain`` and
  each bf16 variant, and JAX's mesh decode of the same dtype token for
  token; ``predict_and_save`` writes the single process's
  ``predict.json`` byte for byte, and ``evaluate`` its scores.
- The multi-host mirror of tests/test_multihost.py: each rank loads its
  ``shard_examples_for_process`` rows and ``make_global_batch`` joins
  them; loss atol 1e-5 and param sums rtol 1e-4 / atol 1e-5 against
  JAX's single process.
- ``dryrun_multichip(2)`` prints OK in a fresh interpreter, and ``entry``
  gives JAX's loss on JAX's params.
"""

import os
import subprocess
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from multimodal_seq2seq_gscan_tpu.core.batch import Batch as JaxBatch
from multimodal_seq2seq_gscan_tpu.decode.greedy import (
    make_greedy_decoder as jax_decoder)
from multimodal_seq2seq_gscan_tpu.models import ModelConfig as JaxConfig
from multimodal_seq2seq_gscan_tpu.models import init_model_params
from multimodal_seq2seq_gscan_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh, shard_batch as jax_shard_batch)
from multimodal_seq2seq_gscan_tpu.train.state import (
    TrainState as JaxState, make_optimizer)
from multimodal_seq2seq_gscan_tpu.train.step import (
    make_train_step as jax_make_train_step)
from multimodal_seq2seq_gscan_tpu_torch.core.batch import Batch
from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
    GroundedScanDataset)
from multimodal_seq2seq_gscan_tpu_torch.decode.greedy import (
    make_greedy_decoder)
from multimodal_seq2seq_gscan_tpu_torch.decode.predict import (
    evaluate, predict_and_save)
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.params import leaves
from multimodal_seq2seq_gscan_tpu_torch.parallel import dryrun
from multimodal_seq2seq_gscan_tpu_torch.parallel.launch import launch
from multimodal_seq2seq_gscan_tpu_torch.parallel.mesh import make_mesh
from multimodal_seq2seq_gscan_tpu_torch.train.checkpoint import (
    load_params, read_checkpoint)
from multimodal_seq2seq_gscan_tpu_torch.train.resident import (
    ResidentData, index_block_stream, make_train_chunk,
    stratified_index_block_stream)
from multimodal_seq2seq_gscan_tpu_torch.train.state import (
    Adam, AdamState, TrainState)
from multimodal_seq2seq_gscan_tpu_torch.train.step import (
    loss_and_grads, train_step)
from tests import torch_parallel_worker as worker
from tests.test_torch_decode_dtype import one_torch_thread  # noqa: F401
from tests.test_torch_train import random_opt_state, to_torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURE = os.path.join(ROOT, "data", "bench_fixture")
CHECKPOINT = os.path.join(FIXTURE, "model_best.msgpack")
DECODE_EXAMPLES = 32
PREDICT_BATCH = 16
NO_DROPOUT = dict(encoder_dropout_p=0.0, decoder_dropout_p=0.0,
                  cnn_dropout_p=0.0)


def jax_batch_of(batch: Batch) -> JaxBatch:
    return JaxBatch(*(jnp.asarray(t.numpy()) for t in batch))


def skewed_batch(batch: Batch) -> Batch:
    """The batch with the first half's targets 4 tokens long (SOS, 2, EOS)
    and the second half's 16: 24 tokens against 120."""
    rng = np.random.RandomState(4)
    rows, width = batch.target_ids.shape
    targets = np.zeros((rows, width), np.int32)
    lengths = np.where(np.arange(rows) < rows // 2, 4, width).astype(np.int32)
    for i, n in enumerate(lengths):
        targets[i, 0], targets[i, n - 1] = 1, 2
        targets[i, 1:n - 1] = rng.randint(3, 9, size=n - 2)
    return batch._replace(target_ids=torch.from_numpy(targets),
                          target_lengths=torch.from_numpy(lengths))


def fixture_data():
    data = GroundedScanDataset(os.path.join(FIXTURE, "dataset.txt"), FIXTURE,
                               split="dev", backend="engine")
    data.read_dataset(max_examples=DECODE_EXAMPLES)
    return data


@pytest.fixture(scope="module")
def case(tmp_path_factory, one_torch_thread):  # noqa: F811
    """The payload, the JAX package's side and the two ranks' results."""
    tiny, batch = dryrun._tiny_config_and_batch()
    kwargs = tiny._asdict()
    for name in ("teacher_forced_impl", "input_padding_idx",
                 "target_pad_idx", "target_sos_idx", "target_eos_idx"):
        kwargs.pop(name)
    jax_config = JaxConfig(**dict(kwargs, **NO_DROPOUT))
    params = init_model_params(jax.random.PRNGKey(0), jax_config)
    opt_state = random_opt_state(params, 7, seed=3)
    jax_state = JaxState(step=jnp.int32(7), params=params,
                         opt_state=opt_state, rng=jax.random.PRNGKey(1))
    state = TrainState(step=7, params=to_torch(params),
                       opt_state=AdamState(7, to_torch(opt_state[0].mu),
                                           to_torch(opt_state[0].nu), 7),
                       rng=np.asarray(jax_state.rng))

    tiled = 4 * batch.input_ids.shape[0]
    rng = np.random.RandomState(1)
    resident = ResidentData(
        *(torch.cat([t] * 4) for t in batch[:2]),
        torch.from_numpy((rng.rand(tiled, *batch.situations.shape[1:])
                          < 0.2).astype(np.uint8)),
        *(torch.cat([t] * 4) for t in batch[3:]))
    lengths = resident.target_lengths.numpy()
    blocks = {
        "full": (next(index_block_stream(tiled, 16, 2,
                                         np.random.default_rng(0))), None),
        "stratified": next(stratified_index_block_stream(
            lengths, 16, 2, np.random.default_rng(0),
            cuts=(int(np.quantile(lengths, 0.8)),), wide_mix=0.5))}

    data = fixture_data()
    decode_batch = next(data.get_data_iterator(
        batch_size=DECODE_EXAMPLES, with_representations=False))[0]
    fixture_config = ModelConfig(
        input_vocabulary_size=data.input_vocabulary_size,
        target_vocabulary_size=data.target_vocabulary_size,
        num_cnn_channels=data.image_channels)
    out_dir = tmp_path_factory.mktemp("ranks")
    payload = dict(
        state=state, config=tiny._replace(**NO_DROPOUT),
        dropout_config=tiny, batch=batch, skew_batch=skewed_batch(batch),
        resident=resident, blocks=blocks, fixture_config=fixture_config,
        params=load_params(CHECKPOINT, device="cpu"),
        decode_inputs=(decode_batch.input_ids, decode_batch.input_lengths,
                       decode_batch.situations,
                       decode_batch.target_positions),
        fixture_data=os.path.join(FIXTURE, "dataset.txt"),
        fixture_directory=FIXTURE, predict_examples=DECODE_EXAMPLES,
        predict_batch=PREDICT_BATCH,
        predict_path=str(out_dir / "predict.json"), out_dir=str(out_dir))
    assert launch(worker.run_cases, 2, payload, device="cpu") == 0
    ranks = [torch.load(out_dir / "rank{}.pt".format(r), weights_only=False)
             for r in range(2)]
    return dict(payload, jax_config=jax_config, jax_state=jax_state,
                jax_mesh=jax_make_mesh(jax.devices()[:2]), ranks=ranks)


def assert_states_close(got, want, rtol, atol):
    for port_tree, ref_tree in zip(got, want):
        assert len(port_tree) == len(ref_tree)
        for port, ref in zip(port_tree, ref_tree):
            np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol,
                                       atol=atol)


def jax_trees(state):
    return tuple(jax.tree.leaves(tree) for tree in (
        state.params, state.opt_state[0].mu, state.opt_state[0].nu))


def port_trees(state):
    return worker.numpy_state(state)


def test_make_mesh_refuses_shapes_that_do_not_cover_the_ranks(case):
    for shape, message in zip(((4, 1), (3, 2), (1, 1), (2, 2)),
                              case["ranks"][0]["refusals"]):
        assert message == "mesh {}x{} requires {} ranks but got 2".format(
            shape[0], shape[1], shape[0] * shape[1])
    assert case["ranks"][0]["model_axis"] == ((1, 2), 0)
    assert case["ranks"][1]["model_axis"] == ((1, 2), 0)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()  # no group in this process


def test_ranks_hold_the_same_state_bit_for_bit(case):
    first, second = case["ranks"]
    for name in ("step", "step_model_axis", "dropout", "chunk_full",
                 "chunk_stratified"):
        for a, b in zip(first[name][1], second[name][1]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=name)
    assert first["multihost"] == second["multihost"]
    assert first["evaluate"] == second["evaluate"]


def test_sharded_step_equals_jax_mesh_step(case):
    step = jax_make_train_step(case["jax_config"], make_optimizer(),
                               mesh=case["jax_mesh"], donate=False)
    new, metrics = step(case["jax_state"], jax_shard_batch(
        case["jax_mesh"], jax_batch_of(case["batch"])))
    got_metrics, got_state = case["ranks"][0]["step"]
    assert got_metrics["loss"] == pytest.approx(float(metrics["loss"]),
                                                abs=1e-5)
    for name in ("accuracy", "exact_match"):
        assert got_metrics[name] == pytest.approx(float(metrics[name]),
                                                  abs=1e-4)
    assert_states_close(got_state, jax_trees(new), 1e-4, 1e-5)


@pytest.mark.parametrize("name", ["step_model_axis",
                                  "multihost_model_axis"])
def test_model_axis_replicates_the_single_process_step(case, name):
    """Over a model axis of 2 both ranks hold every row, from
    ``shard_batch`` or from ``make_global_batch`` joining the processes'
    rows: the single process's step bit for bit."""
    new, metrics = train_step(case["state"], case["batch"], case["config"],
                              Adam())
    for rank in case["ranks"]:
        got_metrics, got_state = rank[name]
        assert got_metrics == {k: float(v) for k, v in metrics.items()}
        for a, b in zip(got_state, port_trees(new)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_loss_is_normalised_over_the_global_batch(case):
    """A mean of per-rank means is what DDP's gradient average computes;
    with 24 tokens on one rank and 120 on the other it misses JAX's loss
    by far more than the bar the sharded step meets."""
    skew = case["skew_batch"]
    jax_state = case["jax_state"]
    step = jax_make_train_step(case["jax_config"], make_optimizer(),
                               mesh=case["jax_mesh"], donate=False)
    _, metrics = step(jax_state, jax_shard_batch(case["jax_mesh"],
                                                  jax_batch_of(skew)))
    ref_loss = float(metrics["loss"])
    loss, grads = case["ranks"][0]["skew"]
    assert loss == pytest.approx(ref_loss, abs=1e-5)
    single_loss, _, single_grads = loss_and_grads(case["state"], skew,
                                                  case["config"])
    for got, want in zip(grads, leaves(single_grads)):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-5)
    halves = [loss_and_grads(case["state"], Batch(*(t[rows] for t in skew)),
                             case["config"])[0]
              for rows in (slice(0, 8), slice(8, 16))]
    mean_of_means = float(sum(halves)) / 2
    assert abs(mean_of_means - ref_loss) > 100 * 1e-5


def test_dropout_two_ranks_equal_the_single_process(case):
    state = case["state"]
    for _ in range(2):
        state, metrics = train_step(state, case["batch"],
                                    case["dropout_config"], Adam())
    got_metrics, got_state = case["ranks"][0]["dropout"]
    assert got_metrics["loss"] == pytest.approx(float(metrics["loss"]),
                                                abs=1e-5)
    assert_states_close(got_state, port_trees(state), 1e-4, 1e-5)


@pytest.mark.parametrize("layout", ["full", "stratified"])
def test_resident_chunk_two_ranks_equal_the_single_process(case, layout):
    block, segments = case["blocks"][layout]
    state, metrics = make_train_chunk(case["dropout_config"], Adam())(
        case["state"], case["resident"], block, segments)
    got_metrics, got_state = case["ranks"][0]["chunk_" + layout]
    np.testing.assert_allclose(got_metrics["loss"], metrics["loss"].numpy(),
                               atol=1e-5)
    assert_states_close(got_state, port_trees(state), 1e-4, 1e-5)


def test_graph_key_is_the_same_on_every_rank_under_a_one_rank_profiler(
        case):
    """With a profiler on rank 0 alone, no rank keys a marked graph of its
    own (its capture's warm-up would run collectives the others do not)."""
    first, second = (rank["graph_key"] for rank in case["ranks"])
    assert first == second == ((4, 4), 4, False)


@pytest.mark.parametrize("impl,dtype", worker.DECODES)
def test_sharded_decode_equals_single_process_and_jax_mesh(case, impl,
                                                           dtype):
    got = case["ranks"][0]["decode_{}".format(dtype or "float32")]
    single = make_greedy_decoder(case["fixture_config"], 120,
                                 decode_impl=impl, compute_dtype=dtype)(
        case["params"], *case["decode_inputs"])
    for name, value in got.items():
        np.testing.assert_array_equal(value, getattr(single, name).numpy(),
                                      err_msg=name)
    config = case["fixture_config"]
    jax_config = JaxConfig(
        input_vocabulary_size=config.input_vocabulary_size,
        target_vocabulary_size=config.target_vocabulary_size,
        num_cnn_channels=config.num_cnn_channels)
    template = jax.eval_shape(lambda key: init_model_params(key, jax_config),
                              jax.random.PRNGKey(0))
    jax_params = flax.serialization.from_state_dict(
        template, read_checkpoint(CHECKPOINT)["params"])
    inputs = [jax_shard_batch(case["jax_mesh"], jnp.asarray(t.numpy()))
              for t in case["decode_inputs"]]
    ref = jax_decoder(jax_config, 120, mesh=case["jax_mesh"],
                      compute_dtype=dtype)(jax_params, *inputs)
    np.testing.assert_array_equal(got["emitted_mask"],
                                  np.asarray(ref.emitted_mask))
    emitted = np.asarray(ref.emitted_mask) > 0
    np.testing.assert_array_equal(got["tokens"] * emitted,
                                  np.asarray(ref.tokens) * emitted)


def test_predict_json_and_evaluate_equal_the_single_process(case, tmp_path):
    data = fixture_data()
    path = predict_and_save(data, case["params"], case["fixture_config"],
                            str(tmp_path / "predict.json"), 120,
                            batch_size=PREDICT_BATCH, device="cpu")
    with open(path, "rb") as f, open(case["predict_path"], "rb") as g:
        single, sharded = f.read(), g.read()
    assert sharded == single and b'"attention_weights_situation"' in single
    assert case["ranks"][0]["evaluate"] == evaluate(
        data, case["params"], case["fixture_config"], 120,
        batch_size=PREDICT_BATCH, device="cpu")


def test_multihost_shards_form_the_global_batch(case):
    step = jax_make_train_step(case["jax_config"], make_optimizer(),
                               donate=False)
    new, metrics = step(case["jax_state"], jax_batch_of(case["batch"]))
    got_metrics, got_sums = case["ranks"][0]["multihost"]
    assert got_metrics["loss"] == pytest.approx(float(metrics["loss"]),
                                                abs=1e-5)
    np.testing.assert_allclose(
        got_sums, [float(np.sum(np.asarray(p)))
                   for p in jax.tree.leaves(new.params)],
        rtol=1e-4, atol=1e-5)


def test_dryrun_multichip_2_in_fresh_subprocess():
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    proc = subprocess.run(
        [sys.executable, "-c", "from multimodal_seq2seq_gscan_tpu_torch."
         "parallel import dryrun; dryrun.dryrun_multichip(2)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dryrun_multichip(2) OK" in proc.stdout


def test_entry_gives_the_jax_loss():
    config, batch = dryrun._tiny_config_and_batch()
    jax_config, jax_batch = __graft_entry__._tiny_config_and_batch()
    for got, want in zip(batch, jax_batch):
        np.testing.assert_array_equal(got.numpy(), want)
    fn, (params, example) = dryrun.entry(device="cpu")
    assert example.input_ids.shape == (16, 8)
    jax_fn, (jax_params, _) = __graft_entry__.entry()
    want = float(jax.jit(jax_fn)(jax_params, jax_batch))
    assert float(fn(to_torch(jax_params), batch)) == pytest.approx(
        want, rel=1e-5)
    assert np.isfinite(float(fn(params, example)))
