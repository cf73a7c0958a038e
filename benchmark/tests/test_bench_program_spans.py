"""The readers of the program's spans and counters
(``harness/program_spans.py`` and their metrics) on synthetic device
operations and spans, and in the tiny cells' traced runs on the CPU."""

import pytest

from benchmark.harness import program_spans
from benchmark.harness.core import Context, _reader
from benchmark.harness.trace import DeviceOp, Trace
from benchmark.tests import tiny


class Span:
    def __init__(self, name, id_, parent, start, end, ms=None, **counts):
        self.name, self.id, self.start_ns, self.end_ns = name, id_, start, end
        self.parent = None if parent is None else parent.id
        self.root = id_ if parent is None else parent.root
        self.counts, self.ms = counts, ms

    def device_ms(self):
        return self.ms


def decode_spans(ms=4.0):
    """Two decode calls: the first before the window (it ends at 90), the
    second in it (100 to 200)."""
    before = Span("gscan.decode", 0, None, 10, 90, host_syncs=2)
    root = Span("gscan.decode", 1, None, 100, 200, host_syncs=3)
    return [before, Span("gscan.decode.encode", 2, before, 15, 40, ms),
            root,
            Span("gscan.decode.check_inputs", 3, root, 101, 110,
                 host_syncs=1),
            Span("gscan.decode.encode", 4, root, 110, 128, ms),
            Span("gscan.decode.exit_check", 5, root, 150, 170,
                 host_syncs=1),
            Span("gscan.decode.exit_check", 6, root, 180, 190,
                 host_syncs=1)]


def context(ops, kind="decode", window_s=1e-7, **counts):
    trace = Trace([DeviceOp("k{}".format(i), a, b)
                   for i, (a, b) in enumerate(ops)], window_s, 0.0, [], 0)
    return Context(trace, dict(counts, kind=kind), {})


@pytest.fixture
def spans(monkeypatch):
    def plant(spans):
        monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    return plant


def test_gaps_are_named_by_the_innermost_program_span(spans):
    spans(decode_spans())
    # Busy 100-105 and 104-112 (overlapping: one interval), 120-130,
    # 160-175, 185-200: gaps begin at 112 (in encode, inside the root),
    # 130 and 175 (in the root alone), none in an exit check.
    ctx = context([(100, 105), (104, 112), (120, 130), (160, 175),
                   (185, 200)])
    assert program_spans.idle_gaps(ctx.trace.ops) == [
        (112, 8), (130, 30), (175, 10)]
    idle = program_spans.idle_by_span(ctx, program_spans.window_spans(ctx))
    assert idle == {"gscan.decode.encode": 8e-9, "gscan.decode": 40e-9}
    assert _reader("device_idle.decode_encoder")(ctx) == pytest.approx(8.0)
    assert _reader("device_idle.decode_syncs")(ctx) == 0.0
    # A gap begun while the host waits in an exit check is the check's.
    ctx = context([(100, 112), (120, 155), (165, 200)])
    assert _reader("device_idle.decode_syncs")(ctx) == pytest.approx(10.0)


def test_the_spans_before_the_window_are_left_out(spans):
    planted = decode_spans()
    spans(planted)
    ctx = context([(100, 200)])
    assert program_spans.window_spans(ctx) == planted[2:]
    assert _reader("host_syncs_per_batch.decode")(ctx) == 3.0
    assert _reader("decode_encoder_ms")(ctx) == 4.0
    # Without device operations (the CPU): every root but the first.
    ctx = context([])
    assert program_spans.window_spans(ctx) == planted[2:]
    assert _reader("host_syncs_per_batch.decode")(ctx) == 3.0


def test_train_readers(spans):
    before = Span("gscan.chunk", 0, None, 0, 50, steps=2)
    first = Span("gscan.chunk", 1, None, 100, 1_000_100, steps=2)
    last = Span("gscan.chunk", 4, None, 2_000_000, 5_000_000, steps=2)
    spans([before, Span("gscan.step.optimizer", 7, before, 1, 2, 9.0),
           first] + [Span("gscan.step.optimizer", i, first, 200, 200, 1.0)
                     for i in (2, 3)]
          + [last] + [Span("gscan.step.optimizer", i, last, 3000, 3000, ms)
                      for i, ms in ((5, 0.5), (6, 0.7))])
    ctx = context([(120, 4_000_000)], kind="train")
    assert _reader("chunk_enqueue_ms")(ctx) == pytest.approx(2.0)
    assert _reader("optimizer_ms_per_step")(ctx) == pytest.approx(0.6)
    assert _reader("host_syncs_per_batch.decode")(ctx) is None


def test_readers_give_nothing_without_device_times_or_spans(spans):
    spans(decode_spans(ms=None))
    ctx = context([])
    for name in ("decode_encoder_ms", "device_idle.decode_encoder",
                 "device_idle.decode_syncs"):
        assert _reader(name)(ctx) is None, name
    assert _reader("decode_encoder_ms")(context([(100, 200)])) is None
    chunk = Span("gscan.chunk", 1, None, 10, 20, steps=1)
    spans([Span("gscan.chunk", 0, None, 0, 5, steps=1), chunk,
           Span("gscan.step.optimizer", 2, chunk, 12, 13)])
    ctx = context([], kind="train")
    assert _reader("optimizer_ms_per_step")(ctx) is None
    assert _reader("chunk_enqueue_ms")(ctx) == pytest.approx(1e-5)
    spans([])  # a program without the recorder
    for name in ("decode_encoder_ms", "device_idle.decode_encoder",
                 "device_idle.decode_syncs", "host_syncs_per_batch.decode"):
        assert _reader(name)(context([(1, 2)])) is None, name
    for name in ("chunk_enqueue_ms", "optimizer_ms_per_step"):
        assert _reader(name)(context([(1, 2)], kind="train")) is None, name


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell,metric", [
    ("tiny.decode", "host_syncs_per_batch.decode"),
    ("tiny.train", "chunk_enqueue_ms")])
def test_a_traced_tiny_cell_reads_the_program_on_the_cpu(checkout, cell,
                                                         metric):
    result = tiny.run(checkout, cell, trace=True)
    assert result["correct"] is True
    assert result["metrics"][metric]["value"] > 0
    if metric == "host_syncs_per_batch.decode":
        # The input check and 1 to 3 exit checks (4 blocks of 32 steps).
        assert 2 <= result["metrics"][metric]["value"] <= 4
