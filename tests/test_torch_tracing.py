"""The port's tracer (``rag_arc_tpu_torch/utils/tracing.py``) on the CPU.

- Off by default: no span is kept, yet every stage feeds the summary.
- ``enable()``: names, parents, request and batch ids, nesting, children
  inside their parents, the ring's bound, 8 threads at once.
- The profiler turns it on the way the benchmark's harness starts it
  (``_enable_profiler`` with ``profile_all_threads`` and the user scope),
  in every thread, and ``_disable_profiler`` turns it off; a span and a
  ``record_function`` range opened together agree on the profiler's clock.
- One HTTP ``/batch`` request over a tiny CPU pipeline with a reranker
  yields every serving span, all under its request id or its batch's id;
  one ``add_documents`` call yields the ingest spans.
"""

import json
import threading
import time
import urllib.request

import pytest
import torch

from rag_arc_tpu_torch.utils import tracing
from rag_arc_tpu_torch.utils.tracing import StageTracer


@pytest.fixture
def traced():
    """Tracing on for the test; the spans that ended after it began."""
    t0 = time.time_ns()
    tracing.enable()
    try:
        yield lambda: tracing.spans(t0)
    finally:
        tracing.disable()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_by_default_and_summary_still_fills():
    tracer = StageTracer()
    assert not tracer.active()
    t0 = time.time_ns()
    with tracer.stage("work", tokens=3) as attrs:
        attrs["slots"] = 4
    with tracer.stage("work", tokens=2, path="direct"):
        pass
    assert tracer.spans(t0) == []
    s = tracer.summary()["work"]
    assert s["count"] == 2 and s["total_ms"] >= 0
    assert s["counts"] == {"tokens": 5, "slots": 4, "path=direct": 1}
    # the process-wide tracer, as GET /stats reads it
    assert not tracing.get_tracer().active()
    with tracing.stage("test.global"):
        pass
    assert tracing.get_tracer().summary()["test.global"]["count"] >= 1


def test_summary_keeps_the_last_samples_of_a_stage():
    tracer = StageTracer(max_samples_per_stage=10)
    for i in range(25):
        tracer.record("s", 0.001, {"queries": i})
    s = tracer.summary()["s"]
    assert s["count"] == 10 and s["counts"]["queries"] == sum(range(15, 25))
    tracer.reset()
    assert tracer.summary() == {}


def test_enabled_spans_nest_with_parents_requests_and_batches():
    tracer = StageTracer()
    tracer.enable()
    t0 = time.time_ns()
    with tracer.stage("root", request=7, queries=2) as attrs:
        with tracer.stage("child", batch=11):
            with tracer.stage("leaf"):
                time.sleep(0.001)
        attrs["bytes"] = 10
    with tracer.stage("other"):
        pass
    tracer.disable()
    with tracer.stage("after"):
        pass
    spans = _by_name(tracer.spans(t0))
    assert set(spans) == {"root", "child", "leaf", "other"}
    root, child, leaf = spans["root"][0], spans["child"][0], spans["leaf"][0]
    assert root.parent_id is None and child.parent_id == root.span_id
    assert leaf.parent_id == child.span_id
    assert (root.request, root.batch) == (7, None)
    assert (child.request, child.batch) == (7, 11) and (leaf.request, leaf.batch) == (7, 11)
    assert spans["other"][0].request is None and spans["other"][0].parent_id is None
    assert root.attrs == {"queries": 2, "bytes": 10}
    for inner, outer in ((child, root), (leaf, child)):
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert leaf.end_ns - leaf.start_ns >= 1_000_000
    assert leaf.thread == threading.get_ident()
    # the window: spans that ended inside it
    assert [s.name for s in tracer.spans(t0, leaf.end_ns)] == ["leaf"]


def test_ring_is_bounded():
    tracer = StageTracer(ring_spans=8)
    tracer.enable()
    for i in range(20):
        with tracer.stage("s", i=i):
            pass
    kept = tracer.spans()
    assert [s.attrs["i"] for s in kept] == list(range(12, 20))
    assert tracer.summary()["s"]["count"] == 20


def test_eight_threads_lose_no_span():
    tracer = StageTracer(ring_spans=4096)
    tracer.enable()
    barrier = threading.Barrier(8)

    def worker(w):
        barrier.wait()
        for i in range(200):
            with tracer.stage("outer", request=w):
                with tracer.stage("inner", i=i):
                    pass

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = tracer.spans()
    assert len(spans) == 8 * 200 * 2
    outer = {s.span_id: s for s in spans if s.name == "outer"}
    for s in spans:
        if s.name == "inner":
            parent = outer[s.parent_id]
            assert parent.request == s.request and parent.thread == s.thread
    assert len({s.span_id for s in spans}) == len(spans)


def _harness_profiler():
    """The profiler the benchmark's ``--trace 1`` runs start
    (``bench_torch/trace.py::DeviceTrace``), CPU activity only."""
    from torch._C._autograd import _prepare_profiler
    from torch._C._profiler import (ProfilerActivity, ProfilerConfig, ProfilerState,
                                    _ExperimentalConfig)

    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                         _ExperimentalConfig(profile_all_threads=True))
    acts = {ProfilerActivity.CPU}
    _prepare_profiler(cfg, acts)
    return cfg, acts


def test_profiler_turns_spans_on_in_every_thread():
    from torch._C._autograd import _disable_profiler, _enable_profiler
    from torch._C._profiler import RecordScope

    cfg, acts = _harness_profiler()
    t0 = time.time_ns()
    assert not tracing.get_tracer().active()
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    try:
        assert tracing.get_tracer().active()
        with tracing.stage("test.profiled.main"):
            pass

        def worker():
            with tracing.stage("test.profiled.thread"):
                pass

        t = threading.Thread(target=worker)
        t.start()
        t.join()
    finally:
        _disable_profiler()
    assert not tracing.get_tracer().active()
    with tracing.stage("test.profiled.after"):
        pass
    names = [s.name for s in tracing.spans(t0)]
    assert names == ["test.profiled.main", "test.profiled.thread"]


def test_span_and_profiler_range_share_the_clock():
    from torch._C._autograd import _disable_profiler, _enable_profiler
    from torch._C._profiler import RecordScope

    cfg, acts = _harness_profiler()
    t0 = time.time_ns()
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    try:
        with tracing.stage("test.clock"):
            with torch.profiler.record_function("test.clock.range"):
                time.sleep(0.005)
    finally:
        result = _disable_profiler()
    span = next(s for s in tracing.spans(t0) if s.name == "test.clock")
    rng = next(e for e in result.events() if e.name() == "test.clock.range")
    start, end = rng.start_ns(), rng.start_ns() + rng.duration_ns()
    # the range nests inside the span on the one clock, within 1 ms; how
    # far inside depends on scheduling, two clocks would be off by far more
    assert span.start_ns - 1_000_000 <= start and end <= span.end_ns + 1_000_000
    # no profiler range is opened by a span
    assert not any(e.name().startswith("test.clock") and e.name() != "test.clock.range"
                   for e in result.events())


# -- the serving and ingest paths -------------------------------------------------

SERVING_SPANS = {
    "http.request", "http.parse", "http.serialise", "batcher.wait", "pipeline.batch",
    "pipeline.retrieve", "pipeline.rerank", "store.tokenize", "store.dispatch",
    "store.fetch", "store.resolve", "index.search", "rerank.prompts", "rerank.forward",
    "rerank.readback",
}
INGEST_SPANS = {
    "store.add", "encoder.tokenize", "encoder.pack", "encoder.forward", "encoder.readback",
    "index.add", "docstore.add",
}
CORPUS = [
    "the cat sat on the mat", "dogs chase cats in yards", "qubits power quantum computing",
    "bond yields rose on inflation", "chocolate cake with dark cocoa",
    "tpus multiply matrices quickly",
]


@pytest.fixture(scope="module")
def encoder():
    from rag_arc_tpu_torch.models.encoder import TransformerConfig
    from rag_arc_tpu_torch.models.torch_embeddings import TorchEncoderEmbeddings

    return TorchEncoderEmbeddings(TransformerConfig.tiny(), device="cpu")


def test_http_batch_request_yields_every_serving_span(encoder, traced):
    from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
    from rag_arc_tpu_torch.models.encoder import TransformerConfig
    from rag_arc_tpu_torch.rerank.cross_encoder import CrossEncoderReranker
    from rag_arc_tpu_torch.serving.app import make_server
    from rag_arc_tpu_torch.serving.pipeline import RagPipeline

    store = TorchVectorStore.from_texts(CORPUS, encoder, device="cpu")
    rr = CrossEncoderReranker(cfg=TransformerConfig.tiny(causal=True, dtype=torch.float32),
                              device="cpu")
    pipe = RagPipeline(store.as_retriever(search_kwargs={"k": 4}), reranker=rr, top_k=2,
                       recall_k=4)
    srv = make_server(pipe, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_port}/batch",
            data=json.dumps({"queries": ["cat on a mat", "quantum bits"]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
        # the root span closes just after the response's last byte is written
        deadline = time.time() + 30
        while not any(s.name == "http.request" for s in traced()) and time.time() < deadline:
            time.sleep(0.01)
        spans = _by_name(traced())
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.server_port}/stats",
                                    timeout=60) as resp:
            stats = json.loads(resp.read())
    finally:
        srv.shutdown()
        srv.server_close()
    assert [len(r) for r in body["results"]] == [2, 2]
    assert SERVING_SPANS <= set(spans)
    (root,) = spans["http.request"]
    rid = root.request
    assert isinstance(rid, int) and root.parent_id is None
    assert root.attrs["queries"] == 2 and root.attrs["route"] == "/batch"
    (batch,) = spans["pipeline.batch"]
    assert batch.request == [rid] and batch.batch is not None
    assert batch.attrs["queries"] == 2
    (wait,) = spans["batcher.wait"]
    assert (wait.request, wait.batch, wait.parent_id) == (rid, batch.batch, root.span_id)
    assert wait.attrs["queries"] == 2 and wait.end_ns <= batch.start_ns
    for name in SERVING_SPANS - {"http.request", "batcher.wait"}:
        for s in spans[name]:
            assert s.request == rid or s.batch == batch.batch, name
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns, name
    assert len(spans["store.resolve"]) == 2
    (search,) = spans["index.search"]
    assert search.attrs == {"path": "direct", "queries": 2, "rows": len(CORPUS)}
    (prompts,) = spans["rerank.prompts"]
    assert prompts.attrs["pairs"] == 8
    assert 0 < prompts.attrs["tokens"] <= prompts.attrs["slots"]
    (ser,) = [s for s in spans["http.serialise"] if s.request == rid]
    assert ser.attrs["bytes"] > 0
    # /stats keeps its keys; queries through the batcher
    assert {"queries", "mean_ms_per_query", "batcher", "stage_timings"} <= set(stats)
    assert stats["queries"] == 2 and stats["mean_ms_per_query"] > 0
    assert stats["stage_timings"]["index.search"]["counts"]["path=direct"] >= 1


def test_add_documents_yields_the_ingest_spans(encoder, traced, tmp_path):
    from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
    from rag_arc_tpu_torch.utils.data_model import Document

    store = TorchVectorStore(encoder, docstore_path=str(tmp_path / "docs"), device="cpu")
    long_text = " ".join(["word"] * 100)  # past the packing limit: bucketed
    docs = [Document(content=t) for t in CORPUS + [long_text]]
    t0 = time.time_ns()
    store.add_documents(docs)
    spans = _by_name(tracing.spans(t0))
    assert INGEST_SPANS <= set(spans)
    (root,) = spans["store.add"]
    assert root.attrs == {"docs": len(docs)} and root.parent_id is None
    ids = {root.span_id}
    for s in sorted(traced(), key=lambda s: s.start_ns):
        if s.parent_id in ids:
            ids.add(s.span_id)
    for name in INGEST_SPANS - {"store.add"}:
        for s in spans[name]:
            assert s.span_id in ids, name
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns, name
    packs = spans["encoder.pack"]
    tokens = sum(s.attrs.get("tokens", 0) for s in packs)
    slots = sum(s.attrs.get("slots", 0) for s in packs)
    assert 0 < tokens <= slots
    for s in packs:
        assert s.attrs.get("tokens", 0) <= s.attrs.get("slots", s.attrs.get("tokens", 0))
    assert spans["index.add"][0].attrs == {"rows": len(docs)}
    assert spans["docstore.add"][0].attrs == {"rows": len(docs)}
