"""Whole runs with the timed path broken underneath: ``correct`` comes
out false (small cells on the CPU, the program's plain versions)."""

import pytest

from benchmark.tests import tiny

STATE_UNCHANGED = """
import multimodal_seq2seq_gscan_tpu_torch.train.resident as resident
step = resident.train_step
def frozen(state, batch, *args, **kwargs):
    new, metrics = step(state, batch, *args, **kwargs)
    return state._replace(step=new.step), metrics
resident.train_step = frozen
"""

HALF_BATCH = """
import multimodal_seq2seq_gscan_tpu_torch.train.resident as resident
step = resident.train_step
def half(state, batch, *args, **kwargs):
    rows = batch.input_ids.shape[0] // 2
    return step(state, type(batch)(*(t[:rows] for t in batch)), *args,
                **kwargs)
resident.train_step = half
"""

TOKEN_ALTERED = """
import torch
import multimodal_seq2seq_gscan_tpu_torch.decode.greedy as greedy
block = greedy.fused_decode_block
def altered(*args, **kwargs):
    out = block(*args, **kwargs)
    tokens = out.step_tokens.clone()
    first = tokens[3]
    tokens[3] = torch.where(first > 2, torch.where(first == 3, 4, 3), first)
    return out._replace(step_tokens=tokens)
greedy.fused_decode_block = altered
"""


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell,fault", [
    ("tiny.train", STATE_UNCHANGED), ("tiny.train", HALF_BATCH),
    ("tiny.decode", TOKEN_ALTERED)])
def test_a_broken_path_is_not_correct(checkout, cell, fault):
    assert tiny.run(checkout, cell)["correct"] is True
    result = tiny.run(checkout, cell, before=fault)
    assert result["correct"] is False
    assert result["failed"] >= 1
