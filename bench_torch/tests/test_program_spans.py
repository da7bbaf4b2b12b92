"""The readers of the program's spans (``bench_torch/program_spans.py`` and
the six metric files that use it) on a synthetic run: hand-made spans and
busy intervals with answers worked out by hand."""

from types import SimpleNamespace

import pytest

from bench_torch import harness, program_spans
from bench_torch.trace import Spans
from rag_arc_tpu_torch.utils import tracing
from rag_arc_tpu_torch.utils.tracing import StageTracer

S = 1_000_000_000  # ns a second


def ns(seconds: float) -> int:
    return round(seconds * S)


def served_spans(tracer: StageTracer) -> None:
    """Four requests around a window of [100 s, 110 s]: R0 began before it,
    R3 ends after it; R1 and R2 inside."""
    def span(name, a, b, request=None, batch=None, **attrs):
        tracer.record_span(name, ns(a), ns(b), parent=(None, request, batch), **attrs)

    span("http.parse", 99.5, 99.51, 10)
    span("batcher.wait", 99.6, 99.7, 10)
    span("http.serialise", 100.4, 100.45, 10)
    span("http.request", 99.5, 100.5, 10)
    span("http.parse", 101.0, 101.01, 11)
    span("batcher.wait", 101.01, 101.05, 11)
    span("rerank.prompts", 101.1, 101.2, [11], 5, tokens=30, slots=64)
    span("pipeline.batch", 101.05, 101.9, [11], 5)
    span("http.serialise", 101.9, 101.95, 11)
    span("http.request", 101.0, 102.0, 11)
    span("http.parse", 103.0, 103.02, 12)
    span("batcher.wait", 103.02, 103.12, 12)
    span("http.serialise", 103.4, 103.43, 12)
    span("http.request", 103.0, 103.5, 12)
    span("rerank.prompts", 104.0, 104.1, None, None, tokens=50, slots=64)
    span("http.request", 109.5, 110.5, 13)
    span("rerank.prompts", 110.2, 110.5, None, None, tokens=1, slots=100)


def fake_run(tracer, monkeypatch, busy):
    monkeypatch.setattr(tracing, "spans", tracer.spans)
    trace = SimpleNamespace(busy_intervals=lambda: [(ns(a), ns(b)) for a, b in busy],
                            window_s=10.0)
    return harness.Run("open", None, 10.0, (100.0, 110.0), Spans(), trace)


BUSY = [(99.9, 100.2), (101.5, 101.8), (105.0, 106.0), (110.2, 110.4)]


@pytest.fixture
def tracer():
    t = StageTracer()
    t.enable()
    return t


def read(metric, run):
    return harness.reader(metric)(run)


def test_served_readers_by_hand(tracer, monkeypatch, capsys):
    served_spans(tracer)
    run = fake_run(tracer, monkeypatch, BUSY)
    # R0, R1, R2 were answered in the window (R3 was not): waits 100, 40, 100 ms
    assert read("queue_wait_ms.lat", run) == pytest.approx(80.0)
    # parse + serialise: 10 + 50, 10 + 50, 20 + 30 ms
    assert read("http_host_ms.lat", run) == pytest.approx(170.0 / 3)
    # two prompt spans ended in the window: 80 tokens of 128 slots
    assert read("rerank_fill_pct.lat", run) == pytest.approx(62.5)
    # requests open 0.5 + 1 + 0.5 + 0.5 s of the window, busy 0.2 + 0.3 s of it
    assert read("inflight_idle_pct.lat", run) == pytest.approx(20.0)
    line = capsys.readouterr().err
    assert "idle card seconds by innermost program span (served" in line


def test_idle_split_sums_to_the_idle_seconds(tracer, monkeypatch):
    served_spans(tracer)
    run = fake_run(tracer, monkeypatch, BUSY)
    split, window_s = program_spans.idle_split(run, "http.request")
    assert window_s == pytest.approx(10.0)
    want = {"no http.request open": 6.5, "http.parse": 0.03, "batcher.wait": 0.14,
            "pipeline.batch": 0.45, "rerank.prompts": 0.1, "http.serialise": 0.13,
            "http.request": 1.15}
    assert split == pytest.approx(want)
    # the window less the card's busy time inside it (0.2 + 0.3 + 1.0 s)
    assert sum(split.values()) == pytest.approx(10.0 - 1.5)


def test_ingest_readers_by_hand(tracer, monkeypatch, capsys):
    def span(name, a, b, **attrs):
        tracer.record_span(name, ns(a), ns(b), **attrs)

    span("encoder.tokenize", 100.50, 100.51)
    span("encoder.pack", 100.51, 100.512)
    span("encoder.pack", 100.512, 100.517, tokens=100, slots=128)
    span("encoder.pack", 100.60, 100.605, tokens=20, slots=64)
    span("encoder.forward", 100.605, 100.7)
    span("store.add", 100.5, 101.0, docs=4)
    span("encoder.tokenize", 102.0, 102.01)
    span("encoder.pack", 102.01, 102.015)
    span("store.add", 102.0, 102.5, docs=4)
    run = fake_run(tracer, monkeypatch, [(100.7, 100.9), (102.2, 102.4)])
    # (10 + 2 + 5 + 5 + 10 + 5) ms over two encode calls
    assert read("encode_host_ms.ingest", run) == pytest.approx(18.5)
    assert read("encoder_fill_pct.ingest", run) == pytest.approx(62.5)
    assert "(ingest; " in capsys.readouterr().err
    split, _ = program_spans.idle_split(run, "store.add")
    assert sum(split.values()) == pytest.approx(10.0 - 0.4)
    assert split["no store.add open"] == pytest.approx(9.0)
    assert split["encoder.forward"] == pytest.approx(0.095)


@pytest.mark.parametrize("metric", [
    "queue_wait_ms.lat", "http_host_ms.lat", "inflight_idle_pct.lat", "rerank_fill_pct.lat",
    "encode_host_ms.ingest", "encoder_fill_pct.ingest"])
def test_readers_give_none_without_spans(metric, tracer, monkeypatch):
    run = fake_run(tracer, monkeypatch, BUSY)
    assert read(metric, run) is None
    # a program without spans (an earlier commit's tracer)
    monkeypatch.delattr(tracing, "spans")
    served_spans(tracer)
    assert read(metric, run) is None


def test_inflight_idle_needs_the_device_trace(tracer, monkeypatch):
    served_spans(tracer)
    run = fake_run(tracer, monkeypatch, BUSY)
    run.trace = None
    assert read("inflight_idle_pct.lat", run) is None
    assert read("queue_wait_ms.lat", run) == pytest.approx(80.0)
