"""Parity of the port's HNSW index with the JAX package's on the CPU.

The engine is the same C++ source (``native/hnsw.cpp``, byte-identical),
built by each package's own loader, so at one seed both build the same
graph: ids must be equal and scores equal to 1e-6 for f32, SQ8, PQ
(staged and trained) and PQ + refine; ``hnsw.bin`` snapshots (and the
store snapshots around them) load in either package; the store maps
``dtype=torch.int8`` to SQ8; the PQ warning and the sentinel and
double-delete refusals hold as in the JAX package's tests.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from rag_arc_tpu.index import persistence as jpers
from rag_arc_tpu.index.hnsw import HNSWIndex as JaxHNSW
from rag_arc_tpu.index.vector_store import TPUVectorStore
from rag_arc_tpu.models.embeddings import HashEmbeddings as JaxHash
from rag_arc_tpu_torch.index import persistence as tpers
from rag_arc_tpu_torch.index.hnsw import HNSWIndex as TorchHNSW
from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
from rag_arc_tpu_torch.models.embeddings import HashEmbeddings

REPO = Path(__file__).resolve().parents[1]
MODES = {
    "f32-cosine": dict(metric="cosine"),
    "f32-l2": dict(metric="l2"),
    "sq8": dict(quantize=True),
    "pq-staged": dict(pq_m=12, pq_train_threshold=4096),
    "pq-trained": dict(pq_m=12, pq_train_threshold=1024),
    "pq-refine": dict(pq_m=12, pq_train_threshold=1024, pq_refine=True),
}


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    data = rng.standard_normal((2000, 48)).astype(np.float32)
    queries = data[rng.integers(0, 2000, 40)] + 0.02 * rng.standard_normal(
        (40, 48)).astype(np.float32)
    return data, queries


def _same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)


def test_engine_source_byte_identical():
    port = (REPO / "rag_arc_tpu_torch" / "native" / "hnsw.cpp").read_bytes()
    assert port == (REPO / "rag_arc_tpu" / "native" / "hnsw.cpp").read_bytes()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_search_ids_equal_at_one_seed(mode, corpus):
    data, queries = corpus
    kw = dict(dim=48, M=16, ef_construction=100, seed=3, **MODES[mode])
    j, t = JaxHNSW(**kw), TorchHNSW(**kw)
    for idx in (j, t):
        idx.add(data[:1200])
        idx.mark_deleted(np.asarray([4, 9]))
        idx.add(data[1200:])
    assert t.stats() == j.stats()
    for k, ef in ((1, None), (10, 64), (25, 128)):
        _same(t.search(queries, k, ef=ef), j.search(queries, k, ef=ef))
    np.testing.assert_array_equal(t.take(np.arange(0, 2000, 97)),
                                  j.take(np.arange(0, 2000, 97)))


@pytest.mark.parametrize("mode", ["f32-cosine", "sq8", "pq-refine"])
def test_hnsw_bin_snapshots_both_ways(mode, corpus, tmp_path):
    data, queries = corpus
    kw = dict(dim=48, M=16, ef_construction=100, **MODES[mode])
    j, t = JaxHNSW(**kw), TorchHNSW(**kw)
    for idx in (j, t):
        idx.add(data)
        idx.mark_deleted(np.asarray([5, 6]))
    j.save(tmp_path / "j.hnsw")
    t.save(tmp_path / "t.hnsw")
    assert (tmp_path / "j.hnsw").read_bytes() == (tmp_path / "t.hnsw").read_bytes()
    metric = kw.get("metric", "cosine")
    from_jax = TorchHNSW.load(tmp_path / "j.hnsw", metric=metric)
    from_port = JaxHNSW.load(tmp_path / "t.hnsw", metric=metric)
    assert from_jax.n_deleted == from_port.n_deleted == 2
    assert from_jax.pq_refine == ("refine" in mode)
    want = j.search(queries[:8], 5)
    _same(from_jax.search(queries[:8], 5), want)
    _same(from_port.search(queries[:8], 5), want)


@pytest.mark.parametrize("store_kw", [{}, {"hnsw_pq_m": 8, "hnsw_pq_refine": True}])
def test_store_snapshots_both_ways(store_kw, tmp_path):
    texts = [f"doc number {i} topic {i % 7}" for i in range(300)]
    ids = [f"d{i}" for i in range(300)]
    j = TPUVectorStore(JaxHash(dim=32), dim=32, index_type="hnsw", **store_kw)
    t = TorchVectorStore(HashEmbeddings(dim=32), dim=32, index_type="hnsw", device="cpu",
                         **store_kw)
    for store in (j, t):
        store.add_texts(texts, ids=ids)
        store.delete(["d3"])
    q = texts[:12]

    def ids_of(store):
        return [[d.id for d, _ in h] for h in store.batch_similarity_search_with_score(q, k=4)]

    assert ids_of(t) == ids_of(j) and "d3" not in ids_of(t)[3]
    jpers.save_store(j, tmp_path / "j")
    tpers.save_store(t, tmp_path / "t")
    from_jax = tpers.load_store(tmp_path / "j", HashEmbeddings(dim=32), device="cpu")
    from_port = jpers.load_store(tmp_path / "t", JaxHash(dim=32))
    assert isinstance(from_jax.index, TorchHNSW) and from_jax.index_type == "hnsw"
    assert from_jax.index.n_deleted == 1
    assert ids_of(from_jax) == ids_of(from_port) == ids_of(j)


def test_store_dtype_int8_selects_sq8(corpus):
    texts = ["alpha beta", "gamma delta", "epsilon zeta"]
    t = TorchVectorStore(HashEmbeddings(dim=32), dim=32, index_type="hnsw",
                         dtype=torch.int8, device="cpu")
    j = TPUVectorStore(JaxHash(dim=32), dim=32, index_type="hnsw", dtype=np.int8)
    for store in (t, j):
        store.add_texts(texts)
    assert t.index.stats()["quantized"] is True and t.index.stats()["storage"] == "sq8"
    assert t.similarity_search("alpha beta", k=1)[0].content == "alpha beta"
    assert [d.content for d in t.similarity_search("gamma", k=3)] == [
        d.content for d in j.similarity_search("gamma", k=3)]
    pq = TorchVectorStore(HashEmbeddings(dim=32), dim=32, index_type="hnsw", hnsw_pq_m=8,
                          device="cpu")
    pq.add_texts([f"doc number {i}" for i in range(40)])
    assert pq.index.stats()["storage"] == "pq"
    assert pq.similarity_search("doc number 17", k=1)[0].content == "doc number 17"


def test_store_mmr_and_deletes_without_compaction():
    t = TorchVectorStore(HashEmbeddings(dim=32), dim=32, index_type="hnsw",
                         compact_threshold=0.1, device="cpu")
    j = TPUVectorStore(JaxHash(dim=32), dim=32, index_type="hnsw", compact_threshold=0.1)
    texts = [f"topic {i} words here" for i in range(12)]
    for store in (t, j):
        store.add_texts(texts, ids=[f"d{i}" for i in range(12)])
        store.delete(["d1", "d2"])  # HNSW has no compact: tombstones stay
    assert t.index.n_deleted == 2
    assert [d.id for d in t.max_marginal_relevance_search("topic 3", k=2, fetch_k=6)] == [
        d.id for d in j.max_marginal_relevance_search("topic 3", k=2, fetch_k=6)]


def test_pq_warning_and_validation():
    with pytest.warns(UserWarning, match="pq_refine"):
        TorchHNSW(dim=64, pq_m=8)  # dsub=8, no refine
    with pytest.raises(ValueError, match="divide"):
        TorchHNSW(dim=48, pq_m=7)
    with pytest.raises(ValueError, match="ONE of"):
        TorchHNSW(dim=48, pq_m=12, quantize=True)
    with pytest.raises(ValueError, match="metric"):
        TorchHNSW(dim=8, metric="hamming")


def test_sentinel_and_double_delete_refusals(tmp_path):
    rows = np.random.default_rng(0).standard_normal((20, 8)).astype(np.float32)
    staged = TorchHNSW(dim=8, pq_m=4, pq_train_threshold=4096)
    staged.add(rows[:10])
    staged.mark_deleted(np.asarray([-1, 100]))  # sentinels / out of range: no-ops
    assert staged.n_deleted == 0
    _, p = staged.search(np.zeros((1, 8), np.float32), k=10)
    assert (p[0] >= 0).sum() == 10
    staged.mark_deleted(np.asarray([3, 3]))
    staged.mark_deleted(np.asarray([3]))
    assert staged.n_deleted == 1
    with pytest.raises(IOError, match="256"):
        staged.save(tmp_path / "tiny.hnsw")
    trained = TorchHNSW(dim=8)
    trained.add(rows)
    trained.mark_deleted(np.asarray([5, 5, 7]))
    trained.mark_deleted(np.asarray([5]))
    assert trained.n_deleted == 2
    with pytest.raises(ValueError, match="positions"):
        trained.take(np.asarray([-1]))
    with pytest.raises(ValueError, match="positive"):
        trained.search(rows[:1], 0)
