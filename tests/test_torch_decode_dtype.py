"""The port's bf16 decode variants against the JAX package's, on the CPU.

On the fixture's first 64 dev examples from the trained checkpoint, at the
bars of the JAX package's own test (tests/test_bench_fixture.py,
``test_bf16_decode_matches_f32_on_trained_model``): ``"bfloat16"`` differs
from the float32 decode in at most 1 sequence, ``"bfloat16_mixed"`` and
``"bfloat16_keys"`` in none, and every variant returns float32 attention
stacks. Every variant's decode equals the JAX package's
decode of the same variant token for token, on the first 64 examples and on
64 around row 1908, which every bf16 variant of both packages decodes
otherwise than its float32 decode (a float32 top-2 logit gap of 0.0040) and
which is the only row that does in those windows (``JAX_FLIPS``); each
variant's loop runs at its dtypes (keys, state, weights and logits, seen at
every ``decoder_step``). ``"bfloat16_keys"`` stores the projected keys in
bf16 and computes in float32, as JAX does, so its attention stacks are also
held at rtol 1e-5 / atol 1e-5 (the JAX attention test's context bar: over
64 examples and 121 steps the two packages' float32 decodes already part by
up to 3.2e-6 in the visual weights) on the rows whose keys round to the
same bf16 values in both packages (the two float32 key projections part by
a few ulps, and where that moves a bf16 rounding the row's keys differ by
one bf16 ulp, about 0.4%). The stacks of ``"bfloat16"`` and
``"bfloat16_mixed"`` come from bf16 arithmetic whose rounding order differs
between the packages (they part by up to 0.08), so only their tokens are
held. A ``"block"`` decode asked for a bf16 dtype
warns once and runs ``"step"``; ``predict`` and ``evaluate`` pass
``decode_dtype`` through, ``"float32"`` included.
"""

import logging
import os

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from multimodal_seq2seq_gscan_tpu.decode.greedy import (
    make_greedy_decoder as jax_decoder)
from multimodal_seq2seq_gscan_tpu.models import ModelConfig as JaxConfig
from multimodal_seq2seq_gscan_tpu.models import init_model_params
from multimodal_seq2seq_gscan_tpu.models.model import (
    encode_input as jax_encode_input)
from multimodal_seq2seq_gscan_tpu.models.model import (
    project_keys as jax_project_keys)
from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
    GroundedScanDataset)
from multimodal_seq2seq_gscan_tpu_torch.decode import greedy
from multimodal_seq2seq_gscan_tpu_torch.decode.greedy import (
    make_greedy_decoder, strip_output_sequences)
from multimodal_seq2seq_gscan_tpu_torch.decode.predict import (
    evaluate, predict)
from multimodal_seq2seq_gscan_tpu_torch.models import config as config_mod
from multimodal_seq2seq_gscan_tpu_torch.models import model
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.model import decoder_step
from multimodal_seq2seq_gscan_tpu_torch.train.checkpoint import (
    load_params, read_checkpoint)

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "data",
                       "bench_fixture")
CHECKPOINT = os.path.join(FIXTURE, "model_best.msgpack")
N_EXAMPLES = 64
# The first row of a second window of N_EXAMPLES dev examples, which holds
# row 1908.
WINDOW = 1856
# The rows of each window that every bf16 variant of the JAX package decodes
# otherwise than its float32 decode (chip_smoke.py holds the card's bf16
# decodes of the fixture's dev examples to them).
JAX_FLIPS = {0: [], WINDOW: [1908]}
INPUTS = ("input_ids", "input_lengths", "situations", "target_positions")
BF16, F32 = torch.bfloat16, torch.float32
# The dtypes of (keys, mask, LSTM state, LSTM weights, logits) that each
# variant's decode loop runs at.
LOOP_DTYPES = {"bfloat16": (BF16, BF16, BF16, BF16, BF16),
               "bfloat16_mixed": (BF16, BF16, BF16, BF16, F32),
               "bfloat16_keys": (BF16, F32, F32, F32, F32)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's torch work: when the suite
    runs under several xdist workers on one host, torch's default of a
    thread per core in each worker oversubscribes the cores and slows these
    small CPU tests many times over. The thread count is restored
    afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fixture():
    data = GroundedScanDataset(os.path.join(FIXTURE, "dataset.txt"), FIXTURE,
                               split="dev")
    data.read_dataset(max_examples=WINDOW + N_EXAMPLES)
    config = ModelConfig(input_vocabulary_size=data.input_vocabulary_size,
                         target_vocabulary_size=data.target_vocabulary_size,
                         num_cnn_channels=data.image_channels)
    batches = {start: batch for start, (batch, _, _, _) in zip(
        range(0, WINDOW + N_EXAMPLES, N_EXAMPLES), data.get_data_iterator(
            batch_size=N_EXAMPLES, with_representations=False))}
    params = load_params(CHECKPOINT, device="cpu")
    f32 = {start: make_greedy_decoder(config, 120)(
        params, *(getattr(batches[start], name) for name in INPUTS))
        for start in JAX_FLIPS}
    return data, config, params, batches, f32


@pytest.fixture(scope="module")
def jax_model(fixture):
    data = fixture[0]
    jax_config = JaxConfig(input_vocabulary_size=data.input_vocabulary_size,
                           target_vocabulary_size=data.target_vocabulary_size,
                           num_cnn_channels=data.image_channels)
    template = jax.eval_shape(lambda key: init_model_params(key, jax_config),
                              jax.random.PRNGKey(0))
    return jax_config, flax.serialization.from_state_dict(
        template, read_checkpoint(CHECKPOINT)["params"])


def sequences(output, config):
    return strip_output_sequences(output, config.target_eos_idx)[0]


@pytest.mark.parametrize("dtype,most", [("bfloat16", 1),
                                        ("bfloat16_mixed", 0),
                                        ("bfloat16_keys", 0)])
def test_bf16_variants_meet_the_jax_bars(fixture, dtype, most):
    _, config, params, batches, f32 = fixture
    batch = batches[0]
    out = make_greedy_decoder(config, 120, compute_dtype=dtype)(
        params, *(getattr(batch, name) for name in INPUTS))
    assert out.attention_commands.dtype == torch.float32
    assert out.attention_situations.dtype == torch.float32
    differ = sum(a != b for a, b in zip(sequences(out, config),
                                        sequences(f32[0], config)))
    assert differ <= most, "{} of {} sequences differ from float32".format(
        differ, N_EXAMPLES)


def decode_as_jax_does(fixture, jax_model, monkeypatch, dtype, start):
    """The port's and JAX's ``dtype`` decodes of the window at ``start``,
    held token for token, with the rows that part from float32 held to
    ``JAX_FLIPS`` and the port's loop held to ``LOOP_DTYPES``."""
    _, config, params, batches, f32 = fixture
    jax_config, jax_params = jax_model
    batch = batches[start]
    seen = set()

    def spied_step(params, config, tokens, state, keys, mask, *rest):
        out = decoder_step(params, config, tokens, state, keys, mask, *rest)
        seen.add((keys.dtype, mask.dtype, state[0].dtype,
                  params.decoder.lstm_layers[0].w_ih.dtype, out[0].dtype))
        return out

    monkeypatch.setattr(greedy, "decoder_step", spied_step)
    ref = jax_decoder(jax_config, max_decoding_steps=120,
                      compute_dtype=dtype)(
        jax_params, *(np.asarray(getattr(batch, name)) for name in INPUTS))
    out = make_greedy_decoder(config, 120, decode_impl="step",
                              compute_dtype=dtype)(
        params, *(getattr(batch, name) for name in INPUTS))
    assert seen == {LOOP_DTYPES[dtype]}
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.emitted_mask.numpy(),
                                  np.asarray(ref.emitted_mask))
    flips = [start + row for row, (a, b) in enumerate(zip(
        sequences(out, config), sequences(f32[start], config))) if a != b]
    assert flips == JAX_FLIPS[start]
    return out, ref


@pytest.mark.parametrize("start", [0, WINDOW])
@pytest.mark.parametrize("dtype", ["bfloat16", "bfloat16_mixed"])
def test_bf16_loop_variants_equal_jax_token_for_token(
        fixture, jax_model, monkeypatch, dtype, start):
    decode_as_jax_does(fixture, jax_model, monkeypatch, dtype, start)


@pytest.mark.parametrize("start", [0, WINDOW])
def test_bfloat16_keys_equals_jax_token_for_token(fixture, jax_model,
                                                  monkeypatch, start):
    _, config, params, batches, _ = fixture
    jax_config, jax_params = jax_model
    out, ref = decode_as_jax_does(fixture, jax_model, monkeypatch,
                                  "bfloat16_keys", start)
    inputs = [getattr(batches[start], name) for name in INPUTS[:3]]
    jax_keys = jax_project_keys(jax_params, jax_encode_input(
        jax_params, jax_config, *(np.asarray(x) for x in inputs)))
    with torch.no_grad():
        keys = model.project_keys(params, model.encode_input(
            params, config, *inputs))
    same = np.ones(N_EXAMPLES, bool)
    for ref_keys, port_keys in zip(jax_keys, keys):
        ref_bf16 = np.asarray(ref_keys.astype("bfloat16").astype("float32"))
        port_bf16 = port_keys.to(torch.bfloat16).float().numpy()
        same &= (ref_bf16 == port_bf16).reshape(N_EXAMPLES, -1).all(axis=1)
    assert same.sum() >= N_EXAMPLES // 4, same.sum()
    for name in ("attention_commands", "attention_situations"):
        np.testing.assert_allclose(getattr(out, name).numpy()[same],
                                   np.asarray(getattr(ref, name))[same],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_block_decode_with_bf16_warns_and_takes_step(fixture, caplog):
    _, config, params, batches, _ = fixture
    args = [getattr(batches[0], name)[:8] for name in INPUTS]
    config_mod._warned.clear()
    with caplog.at_level(logging.WARNING):
        block = make_greedy_decoder(config, 120, decode_impl="block",
                                    compute_dtype="bfloat16_mixed")
    assert any("falling back to 'step'" in r.getMessage()
               and "bfloat16_mixed" in r.getMessage() for r in caplog.records)
    step = make_greedy_decoder(config, 120, decode_impl="step",
                               compute_dtype="bfloat16_mixed")
    assert torch.equal(block(params, *args).tokens,
                       step(params, *args).tokens)
    with pytest.raises(ValueError, match="compute_dtype"):
        make_greedy_decoder(config, 120, compute_dtype="float16")


@pytest.mark.parametrize("dtype", [None, "float32", "bfloat16_keys"])
def test_predict_and_evaluate_pass_the_dtype_through(fixture, dtype):
    data, config, params, _, f32 = fixture
    records = list(predict(data, params, config, 120, batch_size=16,
                           max_examples_to_evaluate=16, decode_dtype=dtype,
                           device="cpu"))
    assert [r["output_ids"] for r in records] == sequences(f32[0],
                                                           config)[:16]
    accuracy, exact, _ = evaluate(data, params, config, 120, batch_size=16,
                                  max_examples_to_evaluate=16,
                                  decode_dtype=dtype, device="cpu")
    assert exact > 90.0 and accuracy > 90.0
