"""The port's serving stack on the CPU, held against the JAX package.

- ``QueryBatcher`` (a copy): the behaviours the JAX package's
  ``tests/test_serving.py`` pins, run against the port's copy.
- The HTTP app: the same requests to the JAX app and the port's app over
  stores of the same documents give equal statuses and, for malformed
  requests, equal bodies; answers carry equal ids (``full`` and ``ids``).
- ``--store``: a hash snapshot written by the JAX package's ingest serves
  unchanged through the port's ``_pipeline_from_store`` with equal
  ``/batch`` ids; a ``torch`` snapshot rebuilds its encoder from the
  manifest, a ``flax`` or custom-weight one is refused.
- Configs: one ``PipelineConfig`` document (hash embeddings, MULTIPATH,
  REWRITE with FAKE_LLM) built by both registries answers equal ids;
  DENSE retrievers with ``index_type`` ivf and hnsw answer the JAX
  package's ids; the port's refusals (FLAX_EMBEDDINGS, graph, the BM25
  mesh backend) and ``device``.
- ``--store`` of IVF and HNSW snapshots written by the JAX package's
  ingest: ``/batch`` ids equal the JAX app's.
- ``RagPipeline``: warm-up re-raises (the JAX package logs), streamed
  batches equal sequential ones, rerank and rewrite stages.
- The runtime serving path imports neither pydantic nor bs4.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from rag_arc_tpu.index.vector_store import TPUVectorStore
from rag_arc_tpu.models.embeddings import HashEmbeddings as JaxHash
from rag_arc_tpu.serving import app as japp
from rag_arc_tpu.serving.pipeline import RagPipeline as JaxPipeline
from rag_arc_tpu_torch.framework.registry import Register
from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
from rag_arc_tpu_torch.models.embeddings import HashEmbeddings
from rag_arc_tpu_torch.serving import app as tapp
from rag_arc_tpu_torch.serving.batcher import QueryBatcher, _Pending
from rag_arc_tpu_torch.serving.configs import PipelineConfig
from rag_arc_tpu_torch.serving.pipeline import RagPipeline
from rag_arc_tpu_torch.utils import tracing
from rag_arc_tpu_torch.utils.data_model import Document

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CORPUS = [
    "the cat sat on the mat",
    "dogs chase cats in yards",
    "qubits power quantum computing",
    "bond yields rose on inflation",
    "chocolate cake with dark cocoa",
    "tpus multiply matrices quickly",
]
IDS = [f"c{i}" for i in range(len(CORPUS))]


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    Register().clear()
    yield
    Register().clear()


def _serve(pipeline, app):
    srv = app.make_server(pipeline, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_port}"


def _request(url, payload=None, raw=None):
    """(status, parsed body) of a POST (or a GET when both are None)."""
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


# -- the batcher (a copy) ------------------------------------------------------


class TestBatcher:
    def test_coalesces_concurrent_requests(self):
        batches = []

        def batch_fn(queries, **kw):
            batches.append(len(queries))
            time.sleep(0.02)  # occupy the "device" so arrivals coalesce
            return [q.upper() for q in queries]

        b = QueryBatcher(batch_fn, max_batch=64, max_wait_ms=30.0)
        results = {}
        threads = [threading.Thread(target=lambda q=f"q{i}": results.update({q: b.submit(q)}))
                   for i in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results["q3"] == "Q3" and sum(batches) == 10 and max(batches) > 1

    def test_submit_many_coalesces_across_requests(self):
        batches = []

        def batch_fn(queries, **kw):
            batches.append(len(queries))
            time.sleep(0.02)
            return [q.upper() for q in queries]

        b = QueryBatcher(batch_fn, max_batch=64, max_wait_ms=30.0)
        out = {}

        def worker(cid):
            out[cid] = b.submit_many([f"c{cid}_q{i}" for i in range(16)])

        threads = [threading.Thread(target=worker, args=(c,)) for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for cid in range(4):
            assert out[cid] == [f"C{cid}_Q{i}" for i in range(16)]
        assert sum(batches) == 64 and max(batches) > 16

    def test_submit_many_slices_at_max_batch(self):
        batches = []

        def batch_fn(queries, **kw):
            batches.append(len(queries))
            return list(queries)

        b = QueryBatcher(batch_fn, max_batch=8, max_wait_ms=5.0)
        assert b.submit_many([f"q{i}" for i in range(21)]) == [f"q{i}" for i in range(21)]
        assert max(batches) <= 8 and sum(batches) == 21

    def test_submit_many_empty_and_error(self):
        def batch_fn(queries, **kw):
            raise RuntimeError("boom")

        b = QueryBatcher(batch_fn, max_batch=8, max_wait_ms=5.0)
        assert b.submit_many([]) == []
        with pytest.raises(RuntimeError, match="boom"):
            b.submit_many(["a", "b"])

    def test_unhashable_kwargs_rejected_at_submit(self):
        b = QueryBatcher(lambda qs, **kw: list(qs), max_batch=4, max_wait_ms=1.0)
        with pytest.raises(TypeError, match="hashable"):
            b.submit("q", k=[10])
        with pytest.raises(TypeError, match="hashable"):
            b.submit_many(["q"], k=[10])
        assert b.submit("ok") == "ok"

    def test_short_batch_fn_result_errors_not_truncates(self):
        b = QueryBatcher(lambda qs, **kw: [qs[0]], max_batch=8, max_wait_ms=1.0)
        p1, p2 = _Pending(query="a", kwargs=()), _Pending(query="b", kwargs=())
        b._in_flight += 1  # _run_batch decrements on its way out
        b._run_batch([p1, p2])
        assert p1.event.is_set() and p2.event.is_set()
        assert isinstance(p1.error, RuntimeError) and "results" in str(p1.error)
        assert b._in_flight == 0

    def test_idle_fast_path_no_window_wait(self):
        sizes = []

        def batch_fn(queries, **kw):
            sizes.append(len(queries))
            return list(queries)

        b = QueryBatcher(batch_fn, max_batch=64, max_wait_ms=10_000.0)
        t0 = time.time()
        assert b.submit("solo") == "solo"
        assert time.time() - t0 < 1.0 and sizes == [1]

    def test_max_batch_flush(self):
        sizes = []
        release = threading.Event()

        def batch_fn(queries, **kw):
            sizes.append(len(queries))
            if len(sizes) == 1:
                release.wait(5.0)
            return list(queries)

        b = QueryBatcher(batch_fn, max_batch=2, max_wait_ms=10_000.0)
        t0 = threading.Thread(target=b.submit, args=("hold",))
        t0.start()
        time.sleep(0.05)
        t1 = threading.Thread(target=b.submit, args=("a",))
        t1.start()
        time.sleep(0.05)
        t2 = threading.Thread(target=b.submit, args=("b",))
        t2.start()
        t1.join(5.0)
        t2.join(5.0)
        assert not t1.is_alive() and not t2.is_alive()
        release.set()
        t0.join(5.0)
        assert sizes[0] == 1 and 2 in sizes

    def test_continuous_batching_drains_queue_on_completion(self):
        sizes = []
        release = threading.Event()

        def batch_fn(queries, **kw):
            sizes.append(len(queries))
            if len(sizes) == 1:
                release.wait(5.0)
            return list(queries)

        b = QueryBatcher(batch_fn, max_batch=64, max_wait_ms=10_000.0)
        threads = [threading.Thread(target=b.submit, args=("first",))]
        threads[0].start()
        time.sleep(0.05)
        for i in range(3):
            threads.append(threading.Thread(target=b.submit, args=(f"q{i}",)))
            threads[-1].start()
        time.sleep(0.05)
        t0 = time.time()
        release.set()
        for t in threads:
            t.join(5.0)
            assert not t.is_alive()
        assert time.time() - t0 < 2.0 and sizes == [1, 3]

    def test_error_propagates(self):
        def batch_fn(queries, **kw):
            raise RuntimeError("engine down")

        with pytest.raises(RuntimeError, match="engine down"):
            QueryBatcher(batch_fn, max_wait_ms=1.0).submit("q")

    def test_kwargs_grouping(self):
        calls = []

        def batch_fn(queries, k=1):
            calls.append((len(queries), k))
            return [k] * len(queries)

        b = QueryBatcher(batch_fn, max_batch=4, max_wait_ms=20.0)
        out = []
        threads = [threading.Thread(target=lambda kk=kk: out.append(b.submit("q", k=kk)))
                   for kk in (1, 1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sorted(out) == [1, 1, 2]
        assert b.stats["requests"] == 3 and b.stats["batches"] >= 2


# -- the HTTP app, against the JAX package's ------------------------------------


@pytest.fixture
def servers():
    jstore = TPUVectorStore(JaxHash(dim=32))
    jstore.add_texts(CORPUS, ids=IDS)
    tstore = TorchVectorStore(HashEmbeddings(dim=32), device="cpu")
    tstore.add_texts(CORPUS, ids=IDS)
    jsrv, jurl = _serve(JaxPipeline(jstore.as_retriever(), batch_wait_ms=1.0), japp)
    tsrv, turl = _serve(RagPipeline(tstore.as_retriever(), batch_wait_ms=1.0), tapp)
    yield jurl, turl
    jsrv.shutdown()
    tsrv.shutdown()


MALFORMED = [
    ("/query", {}), ("/query", {"query": "   "}), ("/query", {"query": 7}),
    ("/query", {"query": "x", "response": "bogus"}),
    ("/batch", {"queries": "hello"}), ("/batch", {"queries": ["ok", ""]}),
    ("/batch", {"queries": ["ok"], "response": "bogus"}),
    ("/add", {"texts": ["a", "b", "c"], "metadatas": [{}]}), ("/add", {"texts": "abc"}),
    ("/nowhere", {"query": "x"}),
]


def test_malformed_requests_match_jax(servers):
    jurl, turl = servers
    for path, payload in MALFORMED:
        want = _request(jurl + path, payload)
        got = _request(turl + path, payload)
        assert got == want, (path, payload)
        assert got[0] in (400, 404)
    # a body that is not JSON is a 500 with the parser's message in both
    assert _request(turl + "/query", raw=b"{not json") == _request(
        jurl + "/query", raw=b"{not json")
    assert _request(turl + "/nowhere") == _request(jurl + "/nowhere")
    # healthy requests still work afterwards
    assert _request(turl + "/query", {"query": "cat mat", "k": 1})[0] == 200


def test_answers_match_jax(servers):
    jurl, turl = servers
    for payload in ({"queries": ["cat mat", "bond yields", "zzz"], "k": 3},
                    {"queries": ["cocoa cake"], "k": 2, "response": "ids"}):
        (js, jb), (ts, tb) = _request(jurl + "/batch", payload), _request(turl + "/batch", payload)
        assert js == ts == 200
        assert [[d["id"] for d in r] for r in tb["results"]] == [
            [d["id"] for d in r] for r in jb["results"]]
    full = _request(turl + "/query", {"query": "quantum qubits", "k": 3})[1]
    slim = _request(turl + "/query", {"query": "quantum qubits", "k": 3, "response": "ids"})[1]
    assert [d["id"] for d in slim["documents"]] == [d["id"] for d in full["documents"]]
    assert set(slim["documents"][0]) == {"id", "score"}
    assert full == _request(jurl + "/query", {"query": "quantum qubits", "k": 3})[1]
    assert _request(turl + "/health") == _request(jurl + "/health")
    status, stats = _request(turl + "/stats")
    assert status == 200 and stats["queries"] >= 6 and stats["batcher"]["requests"] >= 1


def test_add_then_delete_changes_answers(servers):
    _, turl = servers
    status, out = _request(turl + "/add", {"texts": ["ephemeral zebra doc"],
                                           "metadatas": [{"tag": "z"}]})
    assert status == 200 and len(out["ids"]) == 1
    hits = _request(turl + "/query", {"query": "ephemeral zebra doc", "k": 1})[1]
    assert hits["documents"][0]["id"] == out["ids"][0]
    assert hits["documents"][0]["metadata"] == {"tag": "z"}
    assert _request(turl + "/delete", {"ids": out["ids"]}) == (200, {"deleted": True})
    hits = _request(turl + "/query", {"query": "ephemeral zebra doc", "k": 3})[1]
    assert out["ids"][0] not in [d["id"] for d in hits["documents"]]
    assert _request(turl + "/delete", {"ids": ["missing"]}) == (200, {"deleted": False})


# -- --store serving --------------------------------------------------------------


def test_jax_hash_snapshot_serves_with_equal_ids(tmp_path):
    from rag_arc_tpu.tools.ingest import ingest as jingest

    docs = tmp_path / "docs"
    docs.mkdir()
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(200)]
    for i in range(12):
        (docs / f"f{i}.md").write_text(
            "\n\n".join(" ".join(rng.choice(words, 30)) for _ in range(4)))
    jingest(docs, tmp_path / "snap", chunk_size=120, overlap=10, bm25=True, dim=32)
    jpipe = japp._pipeline_from_store(str(tmp_path / "snap"), None, 5)
    tpipe = tapp._pipeline_from_store(str(tmp_path / "snap"), None, 5, device="cpu")
    assert type(tpipe.retriever).__name__ == "MultiPathRetriever"
    queries = [" ".join(rng.choice(words, 5)) for _ in range(8)]
    jsrv, jurl = _serve(jpipe, japp)
    tsrv, turl = _serve(tpipe, tapp)
    try:
        for payload in ({"queries": queries}, {"queries": queries, "response": "ids"}):
            js, jb = _request(jurl + "/batch", payload)
            ts, tb = _request(turl + "/batch", payload)
            assert js == ts == 200
            assert [[d["id"] for d in r] for r in tb["results"]] == [
                [d["id"] for d in r] for r in jb["results"]]
        # the dense snapshot alone too (no BM25 twin next to it)
        dense = tapp._pipeline_from_store(str(tmp_path / "snap" / "dense"), 999, 3, device="cpu")
        want = japp._pipeline_from_store(str(tmp_path / "snap" / "dense"), None, 3)
        assert [[d.id for d in r] for r in dense.query_batch(queries)] == [
            [d.id for d in r] for r in want.query_batch(queries)]
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


@pytest.mark.parametrize("index_type", ["ivf", "hnsw"])
def test_jax_ivf_hnsw_snapshots_serve_with_equal_ids(index_type, tmp_path):
    from rag_arc_tpu.tools.ingest import ingest as jingest

    docs = tmp_path / "docs"
    docs.mkdir()
    rng = np.random.default_rng(1)
    words = [f"w{i}" for i in range(200)]
    for i in range(24):
        (docs / f"f{i}.md").write_text(
            "\n\n".join(" ".join(rng.choice(words, 30)) for _ in range(6)))
    jingest(docs, tmp_path / "snap", chunk_size=120, overlap=10, dim=32,
            index_type=index_type)
    manifest = json.loads((tmp_path / "snap" / "dense" / "manifest.json").read_text())
    assert manifest["index_kind"] == index_type
    jpipe = japp._pipeline_from_store(str(tmp_path / "snap"), None, 5)
    tpipe = tapp._pipeline_from_store(str(tmp_path / "snap"), None, 5, device="cpu")
    assert tpipe.retriever.vectorstore.index.stats()["kind"] == index_type
    queries = [" ".join(rng.choice(words, 5)) for _ in range(8)]
    jsrv, jurl = _serve(jpipe, japp)
    tsrv, turl = _serve(tpipe, tapp)
    try:
        for payload in ({"queries": queries}, {"queries": queries, "response": "ids"}):
            js, jb = _request(jurl + "/batch", payload)
            ts, tb = _request(turl + "/batch", payload)
            assert js == ts == 200
            assert [[d["id"] for d in r] for r in tb["results"]] == [
                [d["id"] for d in r] for r in jb["results"]]
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


def test_store_rebuilds_torch_embedder_and_refuses_flax(tmp_path):
    from rag_arc_tpu.index.persistence import save_store as jsave
    from rag_arc_tpu.models.encoder import TransformerConfig as FlaxCfg
    from rag_arc_tpu.models.flax_embeddings import FlaxEncoderEmbeddings
    from rag_arc_tpu_torch.index.persistence import save_store
    from rag_arc_tpu_torch.models.encoder import TransformerConfig
    from rag_arc_tpu_torch.models.torch_embeddings import TorchEncoderEmbeddings

    texts = ["alpha installation", "beta tuning", "gamma deployment"]
    emb = TorchEncoderEmbeddings(TransformerConfig.tiny(), seed=3, device="cpu")
    save_store(TorchVectorStore.from_texts(texts, emb, device="cpu"), tmp_path / "t")
    pipe = tapp._pipeline_from_store(str(tmp_path / "t"), None, 1, device="cpu")
    served = pipe.retriever.vectorstore.embedding
    assert isinstance(served, TorchEncoderEmbeddings) and served.cfg == emb.cfg
    np.testing.assert_allclose(served.encode(["gamma deployment"]),
                               emb.encode(["gamma deployment"]), rtol=0, atol=1e-6)
    assert pipe.query("gamma deployment")[0].content == "gamma deployment"

    custom = TorchEncoderEmbeddings(TransformerConfig.tiny(), state_dict=emb.model.state_dict(),
                                    device="cpu")
    save_store(TorchVectorStore.from_texts(texts, custom, device="cpu"), tmp_path / "c")
    with pytest.raises(ValueError, match="cannot be rebuilt"):
        tapp._pipeline_from_store(str(tmp_path / "c"), None, 1, device="cpu")

    flax = FlaxEncoderEmbeddings(cfg=FlaxCfg.tiny())
    jsave(TPUVectorStore.from_texts(texts, flax), tmp_path / "f")
    with pytest.raises(ValueError, match="--config"):
        tapp._pipeline_from_store(str(tmp_path / "f"), None, 1, device="cpu")
    with pytest.raises(FileNotFoundError, match="manifest"):
        tapp._pipeline_from_store(str(tmp_path), None, 1, device="cpu")


# -- configs ------------------------------------------------------------------------


CONFIG = {
    "type": "PIPELINE",
    "retriever": {
        "type": "MULTIPATH",
        "retrievers": [
            {"type": "DENSE", "embeddings": {"type": "HASH_EMBEDDINGS", "dim": 32}, "k": 5},
            {"type": "BM25", "k": 5},
        ],
        "top_k": 3,
        "top_k_per_retriever": 5,
    },
    "rewrite": {"type": "REWRITE", "llm": {"type": "FAKE_LLM"}, "n_variants": 2},
    "top_k": 3,
    "batch_max": 16,
    "batch_wait_ms": 1.0,
}


def test_config_pipelines_answer_equal_ids(tmp_path):
    from rag_arc_tpu.framework.registry import Register as JaxRegister
    from rag_arc_tpu.serving.configs import PipelineConfig as JaxConfig
    from rag_arc_tpu.utils.data_model import Document as JaxDocument

    (tmp_path / "j.json").write_text(json.dumps(CONFIG))
    (tmp_path / "t.json").write_text(json.dumps(dict(CONFIG, device="cpu")))
    jpipe = JaxRegister().register(tmp_path / "j.json", "pipeline", JaxConfig)
    tpipe = Register().register(tmp_path / "t.json", "pipeline", PipelineConfig)
    assert tpipe is not None and Register().get_object("pipeline") is tpipe
    assert Register().get_config("pipeline").device == "cpu"
    assert tpipe.rewriter is not None and type(tpipe.rewriter.llm).__name__ == "FakeLLM"
    jpipe.retriever.add_documents([JaxDocument(content=c, id=i) for c, i in zip(CORPUS, IDS)])
    tpipe.retriever.add_documents([Document(content=c, id=i) for c, i in zip(CORPUS, IDS)])
    queries = ["cat mat", "quantum qubits", "dark cocoa cake", "yields"]
    assert [[d.id for d in r] for r in tpipe.query_batch(queries)] == [
        [d.id for d in r] for r in jpipe.query_batch(queries)]
    tsrv, turl = _serve(tpipe, tapp)
    try:
        status, body = _request(turl + "/batch", {"queries": queries})
        assert status == 200
        assert [[d["id"] for d in r] for r in body["results"]] == [
            [d.id for d in r] for r in jpipe.query_batch(queries)]
    finally:
        tsrv.shutdown()


def test_config_refusals_and_device():
    from pydantic import ValidationError

    with pytest.raises(ValidationError):  # the port cannot rebuild Flax weights
        PipelineConfig.model_validate({"type": "PIPELINE", "retriever": {
            "type": "DENSE", "embeddings": {"type": "FLAX_EMBEDDINGS"}}})
    from rag_arc_tpu.serving.configs import PipelineConfig as JaxConfig
    from rag_arc_tpu.utils.data_model import Document as JaxDocument

    dense = {"type": "DENSE", "embeddings": {"type": "HASH_EMBEDDINGS", "dim": 8}}
    # IVF (trained past its threshold of 100 rows) and HNSW answer now,
    # with the JAX package's ids
    texts = [f"doc {i} about topic {i % 9} and {i % 4}" for i in range(150)]
    for index_type in ("ivf", "hnsw"):
        doc = {"type": "PIPELINE", "retriever": dict(dense, index_type=index_type, nlist=8,
                                                     nprobe=8, k=4)}
        tpipe = PipelineConfig.model_validate(dict(doc, device="cpu")).build()
        jpipe = JaxConfig.model_validate(doc).build()
        tpipe.retriever.add_documents([Document(content=c, id=f"d{i}")
                                       for i, c in enumerate(texts)])
        jpipe.retriever.add_documents([JaxDocument(content=c, id=f"d{i}")
                                       for i, c in enumerate(texts)])
        assert tpipe.retriever.vectorstore.index.stats()["kind"] == index_type
        queries = texts[::17]
        got = [[d.id for d in r] for r in tpipe.query_batch(queries)]
        assert got == [[d.id for d in r] for r in jpipe.query_batch(queries)]
        assert all(r[0] == f"d{17 * i}" for i, r in enumerate(got))
    for retriever, match in (({"type": "BM25", "backend": "device"}, r"\[#15\]"),):
        cfg = PipelineConfig.model_validate(
            {"type": "PIPELINE", "retriever": retriever, "device": "cpu"})
        with pytest.raises(NotImplementedError, match=match):
            cfg.build()
    # the graph configs build (the store on the device passed down) and answer
    from rag_arc_tpu_torch.graph.extractor import ExtractionResult
    from rag_arc_tpu_torch.serving.configs import GraphExtractorConfig, GraphStoreConfig

    extractor = GraphExtractorConfig.model_validate({"llm": {"type": "FAKE_LLM"}}).build()
    results = extractor([Document(content="graph text one", id="g1")])
    assert results[0].rounds >= 1
    graph = GraphStoreConfig.model_validate({"embeddings": dense["embeddings"]}).build(
        device="cpu")
    assert graph.device == torch.device("cpu")
    stats = graph.store_hyperrag_graph(
        [ExtractionResult(document=r.document, knowledge=r.knowledge) for r in results])
    assert stats["chunks"] == 1 and graph.health_check()["status"] == "ok"
    cfg = PipelineConfig.model_validate({"type": "PIPELINE", "retriever": dict(
        dense, embeddings={"type": "TORCH_EMBEDDINGS", "dim": 32, "depth": 1, "heads": 2,
                           "vocab_size": 128, "max_len": 32}, dtype="bfloat16")})
    assert cfg.device == "cuda"  # the entry point runs on the card unless asked
    pipe = cfg.model_copy(update={"device": "cpu"}).build()
    store = pipe.retriever.vectorstore
    assert store.device == torch.device("cpu") and store.index.dtype == torch.bfloat16
    assert store.embedding.device == torch.device("cpu") and store.embedding.pack_short


def test_torch_embeddings_pack_short_false_pads_every_text():
    from rag_arc_tpu_torch.serving.configs import TorchEmbeddingsConfig

    kw = {"dim": 32, "depth": 1, "heads": 2, "vocab_size": 128, "max_len": 64}
    packed = TorchEmbeddingsConfig(**kw).build(device="cpu")
    padded = TorchEmbeddingsConfig(**kw, pack_short=False).build(device="cpu")
    calls = []
    padded._encode_packed = lambda *a: calls.append(a)
    texts = ["a b c", "d e", "f g h i j"]
    # the same weights (one seed); packing is block-diagonal attention, so
    # the vectors agree up to the bf16 activations' rounding
    np.testing.assert_allclose(padded.encode(texts), packed.encode(texts), atol=3e-2)
    assert calls == []


def test_hybrid_with_rerank_config():
    cfg = PipelineConfig.model_validate({
        "type": "PIPELINE",
        "retriever": {"type": "MULTIPATH", "retrievers": [
            {"type": "DENSE", "embeddings": {"type": "HASH_EMBEDDINGS", "dim": 32}},
            {"type": "BM25"}]},
        "reranker": {"type": "CROSS_ENCODER", "dim": 64, "depth": 2, "heads": 4,
                     "vocab_size": 512, "max_length": 64},
        "recall_k": 5, "top_k": 2, "device": "cpu",
    })
    pipeline = cfg.build()
    for r in pipeline.retriever.retrievers:
        r.add_documents([Document(content=c) for c in CORPUS])
    docs = pipeline.query_batch(["quantum qubits"])[0]
    assert len(docs) == 2 and all("rerank_score" in d.metadata for d in docs)


def test_registry_failure_returns_none(tmp_path, capsys):
    (tmp_path / "bad.json").write_text(json.dumps({"type": "PIPELINE"}))
    assert Register().register(tmp_path / "bad.json", "p", PipelineConfig) is None
    assert "Error registering p" in capsys.readouterr().out
    assert Register().list_apps() == []


# -- the pipeline --------------------------------------------------------------------


def test_warmup_reraises_where_jax_logs(caplog):
    from rag_arc_tpu.retrieval.base import BaseRetriever as JaxBase
    from rag_arc_tpu_torch.retrieval.base import BaseRetriever

    class Broken(BaseRetriever):
        def _get_relevant_documents(self, query, **kwargs):
            raise RuntimeError("kernel failed to launch")

    class JaxBroken(JaxBase):
        def _get_relevant_documents(self, query, **kwargs):
            raise RuntimeError("kernel failed to launch")

    with pytest.raises(RuntimeError, match="kernel failed to launch"):
        RagPipeline(Broken()).warmup(batch_sizes=(1, 2))
    JaxPipeline(JaxBroken()).warmup(batch_sizes=(1,))  # the JAX package logs
    assert "warmup batch 1 failed" in caplog.text
    store = TorchVectorStore.from_texts(CORPUS, HashEmbeddings(dim=32), device="cpu")
    pipe = RagPipeline(store.as_retriever())
    t0 = time.time_ns()
    tracing.enable()
    try:
        pipe.warmup(batch_sizes=(1, 8))
    finally:
        tracing.disable()
    # one pipeline.batch span a warm-up batch; the warm-up goes round the
    # batcher, whose queries /stats counts
    answered = [s.attrs["queries"] for s in tracing.spans(t0) if s.name == "pipeline.batch"]
    assert sorted(answered) == [1, 8]
    assert pipe.stats()["queries"] == 0


def test_streamed_batches_match_sequential():
    from rag_arc_tpu_torch.retrieval.bm25 import BM25Retriever
    from rag_arc_tpu_torch.retrieval.multipath import MultiPathRetriever

    texts = [f"topic {i % 7} document number {i}" for i in range(60)]
    dense = TorchVectorStore.from_texts(texts, HashEmbeddings(dim=32), device="cpu")
    sparse = BM25Retriever.from_texts(texts, k=5, device="cpu")
    multi = MultiPathRetriever([dense.as_retriever(search_kwargs={"k": 5}), sparse], top_k=3)
    pipe = RagPipeline(retriever=multi, top_k=3, recall_k=5)
    batches = [["topic 1 document", "document number 42"], ["topic 3", "number 7 topic"]]
    for batch, got in zip(batches, pipe.query_batches(batches)):
        assert [[d.id for d in r] for r in got] == [
            [d.id for d in r] for r in pipe.query_batch(batch)]
    assert [[d.id for d in r] for r in pipe.query_batch_shared(batches[0])] == [
        [d.id for d in r] for r in pipe.query_batch(batches[0])]

    from rag_arc_tpu_torch.retrieval.base import BaseRetriever

    class SyncOnly(BaseRetriever):
        def _get_relevant_documents(self, query, **kwargs):
            return [Document(content=f"hit for {query}", id="x")]

    out = RagPipeline(retriever=SyncOnly(), top_k=1).query_batches([["a"], ["b"]])
    assert out[0][0][0].content == "hit for a" and out[1][0][0].content == "hit for b"


def test_rewrite_hybrid_rerank_over_http():
    """Every stage at once through the socket, beside the JAX package's
    pipeline on the same documents and canned rewrites: equal ids."""
    from rag_arc_tpu.llm import FakeLLM as JaxFake
    from rag_arc_tpu.models.encoder import TransformerConfig as FlaxCfg
    from rag_arc_tpu.rerank.cross_encoder import CrossEncoderReranker as JaxCE
    from rag_arc_tpu.retrieval.bm25 import BM25Retriever as JaxBM25
    from rag_arc_tpu.retrieval.multipath import MultiPathRetriever as JaxMulti
    from rag_arc_tpu.retrieval.rewrite import MultiQueryRewriter as JaxRW
    from rag_arc_tpu.retrieval.rewrite import QueryVariants as JaxQV
    from rag_arc_tpu_torch.llm import FakeLLM
    from rag_arc_tpu_torch.models.convert import causal_lm_state_dict_from_flax
    from rag_arc_tpu_torch.models.encoder import TransformerConfig
    from rag_arc_tpu_torch.rerank.cross_encoder import CrossEncoderReranker
    from rag_arc_tpu_torch.retrieval.bm25 import BM25Retriever
    from rag_arc_tpu_torch.retrieval.multipath import MultiPathRetriever
    from rag_arc_tpu_torch.retrieval.rewrite import MultiQueryRewriter, QueryVariants
    import jax
    import jax.numpy as jnp

    jstore = TPUVectorStore(JaxHash(dim=32))
    jstore.add_texts(CORPUS, ids=IDS)
    jce = JaxCE(cfg=FlaxCfg.tiny(causal=True, dtype=jnp.float32))
    jpipe = JaxPipeline(
        JaxMulti([jstore.as_retriever(), JaxBM25.from_texts(CORPUS, ids=IDS)]),
        reranker=jce, rewriter=JaxRW(JaxFake(responder=lambda m, f: JaxQV(queries=["felines"]))),
        top_k=2, recall_k=4)
    tstore = TorchVectorStore(HashEmbeddings(dim=32), device="cpu")
    tstore.add_texts(CORPUS, ids=IDS)
    params = jax.tree_util.tree_map(np.asarray, jce.params)
    tce = CrossEncoderReranker(cfg=TransformerConfig.tiny(causal=True, dtype=torch.float32),
                               params=causal_lm_state_dict_from_flax(params), device="cpu")
    tpipe = RagPipeline(
        MultiPathRetriever([tstore.as_retriever(),
                            BM25Retriever.from_texts(CORPUS, ids=IDS, device="cpu")]),
        reranker=tce, rewriter=MultiQueryRewriter(
            FakeLLM(responder=lambda m, f: QueryVariants(queries=["felines"]))),
        top_k=2, recall_k=4, batch_wait_ms=1.0)
    srv, url = _serve(tpipe, tapp)
    try:
        status, body = _request(url + "/query", {"query": "cats on mats"})
        assert status == 200 and len(body["documents"]) == 2
        assert all("rerank_score" in d["metadata"] for d in body["documents"])
        want = jpipe.query("cats on mats")
        assert [d["id"] for d in body["documents"]] == [d.id for d in want]
        for got, w in zip(body["documents"], want):
            assert abs(got["metadata"]["rerank_score"] - w.metadata["rerank_score"]) < 1e-5
        stats = tpipe.stats()["stage_timings"]
        assert {"pipeline.rewrite", "pipeline.retrieve", "pipeline.rerank"} <= set(stats)
    finally:
        srv.shutdown()


# -- imports --------------------------------------------------------------------------


def test_serving_path_imports_no_pydantic_nor_bs4(tmp_path):
    """Serving a snapshot and ingesting with the hash embedder import
    neither pydantic nor bs4, not even lazily (both are blocked)."""
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "a.md").write_text("# Alpha\nAlpha covers installation.\n\n## Beta\nBeta tuning.")
    (docs / "b.txt").write_text("Gamma explains deployment.")
    code = textwrap.dedent(
        f"""
        import json, sys, threading, urllib.request
        sys.modules["pydantic"] = None
        sys.modules["bs4"] = None
        from rag_arc_tpu_torch.serving.app import _pipeline_from_store, make_server
        from rag_arc_tpu_torch.serving import QueryBatcher, RagPipeline
        from rag_arc_tpu_torch.tools.ingest import main
        assert main([{str(docs)!r}, "-o", {str(tmp_path / "snap")!r}, "--dim", "32",
                     "--bm25", "--device", "cpu"]) == 0
        pipe = _pipeline_from_store({str(tmp_path / "snap")!r}, None, 2, device="cpu")
        pipe.warmup(batch_sizes=(1,))
        srv = make_server(pipe, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        req = urllib.request.Request(
            f"http://127.0.0.1:{{srv.server_port}}/batch",
            data=json.dumps({{"queries": ["gamma deployment"]}}).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            hits = json.loads(resp.read())["results"][0]
        srv.shutdown()
        assert "Gamma" in hits[0]["content"], hits
        bad = sorted(m for m in sys.modules if m.startswith(("jax", "flax", "rag_arc_tpu."))
                     and not m.startswith("rag_arc_tpu_torch"))
        assert not bad, bad
        print("ok")
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=False)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
