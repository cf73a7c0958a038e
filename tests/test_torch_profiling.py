"""The port's spans and counters (``utils/profiling.py``) on the CPU.

With no profiler running, a decode and a resident chunk record nothing,
and they give the same bits as under a profiler. Under torch.profiler a
decode records one ``gscan.decode`` root a call with its children, its
``host_syncs`` one for the input check and one for each exit check that
ran; an eager chunk records one ``gscan.chunk`` root with its steps and
each step's ``gscan.step.optimizer``. Every span's host interval, on
``time.time_ns``'s clock, encloses the kineto events of its own
``record_function`` and of the operators launched inside it (the clock of
the device trace), and the recorder keeps a bounded number of spans. The
marked CUDA graph and the device times are held on the card
(tests/test_torch_kernels.py).
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multimodal_seq2seq_gscan_tpu_torch.decode.greedy import (
    make_greedy_decoder)
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.params import leaves
from multimodal_seq2seq_gscan_tpu_torch.train import resident
from multimodal_seq2seq_gscan_tpu_torch.train.state import (
    Adam, create_train_state)
from multimodal_seq2seq_gscan_tpu_torch.utils import profiling
from tests.test_torch_decode_dtype import one_torch_thread  # noqa: F401
from tests.test_torch_kernels import resident_toy

CONFIG = ModelConfig(input_vocabulary_size=12, target_vocabulary_size=8,
                     num_cnn_channels=6, embedding_dimension=10,
                     encoder_hidden_size=12, decoder_hidden_size=12,
                     cnn_kernel_size=3, cnn_hidden_num_channels=6,
                     auxiliary_task=True)
STEPS, BLOCK = 9, 2  # 10 decoder steps in 5 blocks: up to 4 exit checks


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.recorder.clear()
    yield
    profiling.recorder.clear()


@pytest.fixture(scope="module")
def toy():
    data = resident_toy("cpu", n=24)
    state = create_train_state(5, CONFIG, Adam(), device="cpu")
    decode = make_greedy_decoder(CONFIG, STEPS, exit_check_every=BLOCK)
    return data, state, decode


def decode_once(toy):
    data, state, decode = toy
    rows = slice(0, 16)
    return decode(state.params, data.input_ids[rows],
                  data.input_lengths[rows], data.situations[rows].float(),
                  data.target_positions[rows])


def chunk_once(toy, k=3):
    data, state, _ = toy
    block = next(resident.index_block_stream(data.num_examples, 8, k,
                                             np.random.default_rng(3)))
    return resident.make_train_chunk(CONFIG, Adam())(state, data, block)


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_nothing_recorded_without_a_profiler_and_the_same_bits(toy):
    assert profiling.span("gscan.a") is profiling.span("gscan.b")
    plain = decode_once(toy), chunk_once(toy)
    assert profiling.recorder.spans() == []
    (decoded, (state, metrics)), _ = traced(
        lambda: (decode_once(toy), chunk_once(toy)))
    assert profiling.recorder.spans()
    for a, b in zip(plain[0], decoded):
        assert (a is None and b is None) or torch.equal(a, b)
    for a, b in zip(leaves((plain[1][0].params, plain[1][0].opt_state.mu,
                            plain[1][0].opt_state.nu)),
                    leaves((state.params, state.opt_state.mu,
                            state.opt_state.nu))):
        assert torch.equal(a, b)
    for name, value in plain[1][1].items():
        assert torch.equal(value, metrics[name]), name


def children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_decode_spans_roots_children_and_host_syncs(toy):
    traced(lambda: [decode_once(toy) for _ in range(2)])
    spans = profiling.recorder.spans()
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["gscan.decode"] * 2
    for root in roots:
        kids = children(spans, root)
        names = [s.name for s in kids]
        assert names[:2] == ["gscan.decode.check_inputs",
                             "gscan.decode.encode"]
        checks = names[2:]
        assert 1 <= len(checks) <= -(-(STEPS + 1) // BLOCK) - 1
        assert set(checks) == {"gscan.decode.exit_check"}
        assert root.counts == {"host_syncs": 1 + len(checks)}
        for kid in kids:
            assert kid.root == root.id and not children(spans, kid)
            assert root.start_ns <= kid.start_ns <= kid.end_ns \
                <= root.end_ns
            assert kid.counts == ({} if kid.name == "gscan.decode.encode"
                                  else {"host_syncs": 1})
            assert kid.device_ms() is None  # no device on the CPU


def test_eager_chunk_spans(toy):
    traced(lambda: chunk_once(toy, k=3))
    spans = profiling.recorder.spans()
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "gscan.chunk" and root.counts == {"steps": 3}
    assert [s.name for s in children(spans, root)] == \
        ["gscan.step.optimizer"] * 3


def test_host_intervals_enclose_their_kineto_events(toy):
    _, prof = traced(lambda: (decode_once(toy), chunk_once(toy, k=2)))
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    spans = profiling.recorder.spans()
    assert len(spans) > 8
    for record in spans:
        (function,) = [e for e in events if e[0] == record.name
                       and record.start_ns <= e[1] <= record.end_ns]
        assert function[2] <= record.end_ns, record.name
        inside = [e for e in events if e[0].startswith("aten::")
                  and function[1] <= e[1] < function[2]]
        assert inside, record.name
        for _, start, end in inside:
            assert record.start_ns <= start <= end <= record.end_ns


def test_the_recorder_is_bounded():
    recorder = profiling.Recorder(capacity=8)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(20):
            with recorder.span("gscan.test"):
                recorder.count("n", i)
    spans = recorder.spans()
    assert len(spans) == 8
    assert [s.counts["n"] for s in spans] == list(range(12, 20))


def test_graph_key_marks_a_traced_single_process(toy):
    """A single process's chunk graph under a profiler is keyed apart from
    its untraced graph (it holds the optimizer spans' device markers)."""
    data, _, _ = toy
    graphs = resident.ChunkGraphs(CONFIG, Adam(), 0.3)
    plain = graphs.key((4, 4), 8, data)
    with profile(activities=[ProfilerActivity.CPU]):
        marked = graphs.key((4, 4), 8, data)
    assert plain[:-1] == marked[:-1]
    assert (plain[-1], marked[-1]) == (False, True)


@pytest.mark.parametrize("units", [4, 1])
def test_step_profiler_drops_its_warm_up_unit(tmp_path, units):
    """``StepProfiler`` writes one trace of the units after the first: the
    first unit's trace is dropped when the next starts, and kept where the
    run ends after it."""
    profiler = profiling.StepProfiler(str(tmp_path), start_step=3,
                                      num_steps=2)
    for step in range(3, 3 + units):
        profiler.maybe_start(step)
        with torch.profiler.record_function(
                "gscan.warm" if step == 3 else "gscan.steady"):
            torch.ones(4).sum()
        profiler.maybe_stop(step)
    profiler.close()
    (trace,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    if units == 1:
        assert "gscan.warm" in names and "gscan.steady" not in names
    else:
        assert "gscan.steady" in names and "gscan.warm" not in names
