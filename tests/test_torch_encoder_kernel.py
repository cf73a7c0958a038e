"""On the card: the encoder kernel (``ops/encoder_lstm.py``,
``csrc/encoder_lstm.cu``) gives ``encode_input`` the plain scan's results.

JAX-free, so that it runs on the card, where tests/conftest.py cannot load
(it imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_encoder_kernel.py

``encode_input`` without autograd (the kernel, one launch a layer) against
``encode_input`` under autograd with weights that require grad (the plain
``masked_lstm_scan``, no launch), at H = 12, 100 and 512 and at an input
too wide for shared memory (the kernel's global scratch), one direction or
two, one layer or two; lengths 1 to T (full rows and rows of length 1),
batches that are no multiple of any row tile. Outputs and hidden within
atol 1e-5 (float32 sums in two orders; 5e-5 at the 8,192-wide input,
where both versions lie ~1e-5 from float64), no further from a float64
evaluation than twice the plain version (or 1e-6), the same bits from run
to run. The fixture's 4,096-row greedy decode launches the kernel once
(the wrapper's ``launches``) and counts one kernel layer
(``encoder_kernel_layers``, read under a host-only profiler), and gives
the plain encoder's decode's tokens, at 99.2676% exact match.
"""

import os

import numpy as np
import pytest
import torch

from multimodal_seq2seq_gscan_tpu_torch.models import model
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.params import (
    leaves, tree_map)
from multimodal_seq2seq_gscan_tpu_torch.ops import encoder_lstm
from multimodal_seq2seq_gscan_tpu_torch.train.state import (
    Adam, create_train_state)
from tests.test_torch_kernels import cuda  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "data",
                       "bench_fixture")
# name: (embedding E, H, batch, whether the first layer's activations go to
# the global scratch, atol against the plain scan). At E = 8,192 a gate's
# sum runs over 8,256 terms of ~1e2 in magnitude, and both versions lie
# ~1e-5 from float64 (on an H100: kernel 1.17e-5 and 1.09e-5, plain
# 1.89e-5 and 8.2e-6), so they are held within 5e-5 of each other and by
# the float64 referee.
SHAPES = {"H12": (10, 12, 8485, False, 1e-5),
          "H100": (25, 100, 8485, False, 1e-5),
          "H512": (25, 512, 2085, False, 1e-5),
          "E8192": (8192, 64, 301, True, 5e-5)}
STEPS = 16


def encoder_inputs(config, batch, device):
    rng = np.random.RandomState(11)
    lengths = rng.randint(1, STEPS + 1, size=batch)
    lengths[:2] = (STEPS, 1)
    ids = np.zeros((batch, STEPS), np.int64)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.randint(1, config.input_vocabulary_size, size=n)
    situations = rng.rand(batch, 4, 4, config.num_cnn_channels)
    return tuple(torch.from_numpy(a).to(device) for a in (
        ids, lengths.astype(np.int32), situations.astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_encoder_kernel_matches_plain_scan(cuda, name, bidirectional,
                                           layers):
    embedding, hidden, batch, scratch, atol = SHAPES[name]
    config = ModelConfig(
        input_vocabulary_size=13, target_vocabulary_size=9,
        num_cnn_channels=4, embedding_dimension=embedding,
        encoder_hidden_size=hidden, decoder_hidden_size=hidden,
        num_encoder_layers=layers, encoder_bidirectional=bidirectional,
        cnn_kernel_size=3, cnn_hidden_num_channels=6)
    params = create_train_state(5, config, Adam(), device=cuda).params
    inputs = encoder_inputs(config, batch, cuda)
    plan = encoder_lstm.layer_plan(batch, embedding, hidden,
                                   torch.cuda.current_device())
    assert plan.scratch == scratch, plan

    launches = encoder_lstm.launches
    with torch.no_grad():
        got = model.encode_input(params, config, *inputs)
        again = model.encode_input(params, config, *inputs)
    torch.cuda.synchronize()
    assert encoder_lstm.launches == launches + 2 * layers
    assert torch.equal(got.encoded_commands, again.encoded_commands)
    assert torch.equal(got.hidden, again.hidden)

    exact = model.encode_input(tree_map(torch.Tensor.double, params), config,
                               inputs[0], inputs[1], inputs[2].double())
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    with torch.enable_grad():
        plain = model.encode_input(params, config, *inputs)
    assert encoder_lstm.launches == launches + 2 * layers
    for field in ("encoded_commands", "hidden"):
        kernel, want, truth = (getattr(e, field) for e in (got, plain, exact))
        want = want.detach()
        kernel_err = float((kernel.double() - truth).abs().max())
        plain_err = float((want.double() - truth).abs().max())
        torch.testing.assert_close(
            kernel, want, rtol=0, atol=atol,
            msg=lambda m: "{} (from float64: kernel {}, plain {}): {}".format(
                field, kernel_err, plain_err, m))
        assert kernel_err <= max(2 * plain_err, 1e-6), (field, kernel_err,
                                                        plain_err)


@pytest.mark.cuda
def test_fixture_decode_takes_the_encoder_kernel(cuda, monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
        GroundedScanDataset)
    from multimodal_seq2seq_gscan_tpu_torch.decode.greedy import (
        make_greedy_decoder, strip_output_sequences)
    from multimodal_seq2seq_gscan_tpu_torch.train.checkpoint import (
        load_params)
    from multimodal_seq2seq_gscan_tpu_torch.utils import profiling
    dataset = GroundedScanDataset(os.path.join(FIXTURE, "dataset.txt"),
                                  FIXTURE, split="dev")
    dataset.read_dataset(max_examples=4096)
    config = ModelConfig(input_vocabulary_size=dataset.input_vocabulary_size,
                         target_vocabulary_size=dataset.target_vocabulary_size,
                         num_cnn_channels=dataset.image_channels)
    params = load_params(os.path.join(FIXTURE, "model_best.msgpack"),
                         device=cuda)
    batch, indices, _, _ = next(dataset.get_data_iterator(
        batch_size=4096, with_representations=False))
    batch = batch.to(cuda)
    inputs = (batch.input_ids, batch.input_lengths, batch.situations,
              batch.target_positions)
    decode = make_greedy_decoder(config, 120)

    # The wrapper's own count of launches, then the decode's counter
    # ``encoder_kernel_layers``, which the port records while a profiler
    # runs (a host-only profiler: the counter is host bookkeeping).
    launches = encoder_lstm.launches
    got = decode(params, *inputs)
    torch.cuda.synchronize()
    assert encoder_lstm.launches == launches + 1
    profiling.recorder.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        again = decode(params, *inputs)
        torch.cuda.synchronize()
    roots = [r for r in profiling.recorder.spans() if r.name == "gscan.decode"]
    profiling.recorder.clear()
    assert [r.counts.get("encoder_kernel_layers") for r in roots] == [1]
    assert encoder_lstm.launches == launches + 2
    assert torch.equal(got.tokens, again.tokens)

    launches = encoder_lstm.launches
    monkeypatch.setattr(model, "_encoder_kernel_applies", lambda *_: False)
    want = decode(params, *inputs)
    assert encoder_lstm.launches == launches
    assert torch.equal(got.tokens, want.tokens)
    sequences, _ = strip_output_sequences(got, config.target_eos_idx)
    matched = sum(seq == dataset.target_ids[int(i)][1:-1].tolist()
                  for seq, i in zip(sequences, indices))
    assert len(indices) == 4096
    assert round(100.0 * matched / len(indices), 4) == 99.2676
