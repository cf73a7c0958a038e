"""The plain reference against the port's plain path at H = 12 on the
CPU: the training loss and its gradients under the same dropout, Adam's
update, and the replay of a greedy decode."""

import numpy as np
import pytest
import torch

from benchmark.harness import fixture, program, weights
from benchmark.reference import decode as ref_decode
from benchmark.reference.model import Arithmetic, training_loss
from benchmark.reference.train import adam_scalars, follow, step_seed

from benchmark.tests.tiny import REPO, TINY_CONFIG

CFG = dict(__import__("json").loads(
    (REPO / "benchmark/configs/gscan_baseline.json").read_text()),
    **TINY_CONFIG)


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    split = fixture.load_split(REPO, CFG["data"], "train",
                               bucket_inputs=False)
    sizes = fixture.vocabulary_sizes(REPO, CFG["data"])
    channels = split.situations.shape[-1]
    leaves = weights.layout(CFG, *sizes, channels)
    W = weights.generate(leaves, 2**31 + 5, "cpu")
    config = program.model_config(CFG, *sizes, channels)
    return split, W, config


def batch_of(split, rows):
    take = lambda c: torch.from_numpy(np.ascontiguousarray(c[rows]))
    return (take(split.input_ids), take(split.input_lengths),
            take(split.situations).float(), take(split.target_ids))


def test_loss_and_gradients_match_the_port(setup):
    from multimodal_seq2seq_gscan_tpu_torch.core.batch import Batch
    from multimodal_seq2seq_gscan_tpu_torch.train.state import Adam, TrainState
    from multimodal_seq2seq_gscan_tpu_torch.train.step import loss_and_grads
    split, W, config = setup
    rows = np.arange(6)
    key = weights.key(2**31 + 5)
    state = TrainState(step=0, params=program.model_params(W),
                       opt_state=Adam().init(program.model_params(W)),
                       rng=key)
    cols = [torch.from_numpy(np.ascontiguousarray(c[rows])) for c in split]
    cols[2] = cols[2].float()
    port_loss, _, port_grads = loss_and_grads(state, Batch(*cols), config)
    leaves = {n: t.clone().requires_grad_(True) for n, t in W.items()}
    generator = torch.Generator().manual_seed(step_seed(key, 0))
    loss = training_loss(Arithmetic(), leaves, CFG, batch_of(split, rows),
                         generator)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    loss = float(loss.detach())
    assert abs(loss - float(port_loss)) <= 1e-5 * abs(loss)
    port = program.named(port_grads)
    for name, grad in zip(leaves, grads):
        scale = max(float(grad.abs().max()), 1e-6)
        assert float((grad - port[name]).abs().max()) <= 1e-4 * scale, name


def test_adam_follows_the_port(setup):
    from multimodal_seq2seq_gscan_tpu_torch.train.state import Adam
    optimizer = Adam(learning_rate=CFG["learning_rate"],
                     b1=CFG["adam_beta_1"], b2=CFG["adam_beta_2"],
                     lr_decay=CFG["lr_decay"],
                     lr_decay_steps=CFG["lr_decay_steps"])
    for count in (0, 1, 7, 30000):
        bias1, bias2, step = optimizer.scalars(count, count)
        lr, ref1, ref2 = adam_scalars(CFG, count)
        assert (bias1, bias2, step) == (ref1, ref2, -lr)


def test_three_steps_follow_the_port(setup):
    """The reference's three steps against three eager steps of the
    port's ``train_step`` (dropout from the same seeds)."""
    from multimodal_seq2seq_gscan_tpu_torch.core.batch import Batch
    from multimodal_seq2seq_gscan_tpu_torch.train.state import Adam, TrainState
    from multimodal_seq2seq_gscan_tpu_torch.train.step import train_step
    split, W, config = setup
    optimizer = Adam(learning_rate=CFG["learning_rate"],
                     b1=CFG["adam_beta_1"], b2=CFG["adam_beta_2"],
                     lr_decay=CFG["lr_decay"],
                     lr_decay_steps=CFG["lr_decay_steps"])
    key = weights.key(2**31 + 5)
    params = program.model_params({n: t.clone() for n, t in W.items()})
    state = TrainState(0, params, optimizer.init(params), key)
    rows = np.arange(18).reshape(3, 6)
    losses = []
    for r in rows:
        cols = [torch.from_numpy(np.ascontiguousarray(c[r])) for c in split]
        cols[2] = cols[2].float()
        state, metrics = train_step(state, Batch(*cols), config, optimizer)
        losses.append(float(metrics["loss"]))
    followed = follow(W, CFG, [batch_of(split, r) for r in rows], key,
                      Arithmetic())
    np.testing.assert_allclose(followed.losses, losses, rtol=1e-5)
    port = program.named(state.params)
    for name, value in followed.params.items():
        change = value - W[name]
        scale = max(float(change.abs().max()), 1e-12)
        assert float((port[name] - value).abs().max()) <= 1e-3 * scale, name


def test_replay_of_the_port_decode(setup):
    """Replaying the port's greedy decode: every served token is the
    reference's argmax, and both attention stacks agree, frozen rows and
    skipped blocks included."""
    from multimodal_seq2seq_gscan_tpu_torch.decode.greedy import (
        make_greedy_decoder)
    _, W, config = setup
    dev = fixture.load_split(REPO, CFG["data"], "dev", bucket_inputs=True)
    rows = np.arange(40)
    decode = make_greedy_decoder(config, CFG["max_decoding_steps"],
                                 decode_impl="block_plain")
    take = lambda c: torch.from_numpy(np.ascontiguousarray(c[rows]))
    inputs = (take(dev.input_ids), take(dev.input_lengths),
              take(dev.situations).float())
    out = decode(program.model_params(W), *inputs, take(dev.target_positions))
    longest = int(out.lengths.max())
    steps_run = torch.full((len(rows),), min(-(-longest // 32) * 32, 121))
    replay = ref_decode.replay(Arithmetic(), W, CFG, *inputs, out.tokens,
                               steps_run)
    emitted = (torch.arange(121)[None] < replay.lengths[:, None])
    best = replay.logits.argmax(-1)
    assert bool(((best == out.tokens.long()) | ~emitted).all())
    assert torch.equal(replay.lengths, out.lengths.long())
    assert float((replay.attn_cmd - out.attention_commands).abs().max()) < 1e-5
    assert float((replay.attn_sit - out.attention_situations).abs().max()) \
        < 1e-5
