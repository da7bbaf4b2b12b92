"""The BM25 slice on the CPU: ``rag_arc_tpu_torch``'s ``ops/bm25.py``,
``index/bm25.py`` and ``retrieval/bm25.py`` against the JAX package's on
the same inputs. Corpora are zipf CSR arrays from a numpy seed (the
recipe of ``tools/bm25_bench.py::synth_csr``, copied into the port as
``rag_arc_tpu_torch/tools/bm25_synth.py``).

Tolerances: idf and document weights bit-equal; the doc-major scan
within rtol 1e-5, atol 1e-6; every top-k within rtol 1e-4, atol 1e-5
(scatter-add and matmul orders differ between XLA and torch), ids equal
or, where they differ, equal scores after sorting (the tie rule of
``tests/test_bm25.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rag_arc_tpu.index.bm25 import DeviceBM25Index as JIndex
from rag_arc_tpu.ops import bm25 as jops
from rag_arc_tpu.retrieval.bm25 import BM25Retriever as JRetriever
from rag_arc_tpu_torch.index.bm25 import DeviceBM25Index as TIndex
from rag_arc_tpu_torch.ops import bm25 as tops
from rag_arc_tpu_torch.retrieval.bm25 import BM25Retriever as TRetriever
from rag_arc_tpu_torch.tools.bm25_synth import csr_texts, mixed_queries, synth_csr

CPU = "cpu"
N_DOCS = 3000
VOCAB = 400


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def csr():
    return synth_csr(np.random.default_rng(0), N_DOCS, vocab=VOCAB, mean_len=40)


def _assert_topk_close(got, want):
    """Scores within rtol 1e-4, atol 1e-5; per row ids equal, or the same
    scores after sorting where near-ties reorder."""
    gs, gp = got
    ws, wp = want
    np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-5)
    for i in range(len(gs)):
        assert set(gp[i].tolist()) == set(wp[i].tolist()) or np.allclose(
            np.sort(gs[i]), np.sort(ws[i]), rtol=1e-4
        ), i


def _queries(seed, n):
    """Queries over the small vocabulary: head (zipf) and selective
    (uniform over the upper half of the vocabulary) profiles, mixed with
    zero-match rows."""
    rng = np.random.default_rng(seed)
    head = [[f"w{t}" for t in rng.zipf(1.3, size=8) % VOCAB] for _ in range(n)]
    sel = [[f"w{t}" for t in rng.integers(VOCAB // 2, VOCAB, size=4)] for _ in range(n)]
    return head, sel, mixed_queries(head, sel)


# -- ops ---------------------------------------------------------------------


def test_idf_and_weights_bit_equal(csr):
    tid = csr[1]
    df = np.bincount(tid, minlength=VOCAB).astype(np.float64)
    np.testing.assert_array_equal(tops.compute_idf(df, N_DOCS), jops.compute_idf(df, N_DOCS))
    # a df=0 filler id and a stopword-heavy corpus (negative idf mean)
    df2 = np.array([0, 2900, 2950, 10, 0, 1500], dtype=np.float64)
    np.testing.assert_array_equal(tops.compute_idf(df2, 3000, 0.3),
                                  jops.compute_idf(df2, 3000, 0.3))
    rng = np.random.default_rng(1)
    tf = rng.integers(0, 5, (64, 16)).astype(np.float32)
    idf = rng.random((64, 16)).astype(np.float32)
    dl = rng.integers(5, 90, 64).astype(np.float64)
    np.testing.assert_array_equal(
        tops.compute_doc_weights(tf, idf, dl, float(dl.mean()), 1.2, 0.7),
        jops.compute_doc_weights(tf, idf, dl, float(dl.mean()), 1.2, 0.7),
    )


def _doc_major(seed, n=700, dmax=16, v=120, b=5, q=6):
    rng = np.random.default_rng(seed)
    terms = np.full((n, dmax), tops.DOC_PAD, np.int32)
    for i in range(n):
        m = int(rng.integers(1, dmax + 1))
        terms[i, :m] = rng.choice(v, m, replace=False)
    weights = np.where(terms >= 0, rng.random((n, dmax)), 0).astype(np.float32)
    qt = np.full((b, q), tops.QUERY_PAD, np.int32)
    qc = np.zeros((b, q), np.float32)
    for i in range(b):
        m = int(rng.integers(1, q + 1))
        qt[i, :m] = rng.choice(v, m, replace=False)
        qc[i, :m] = rng.integers(1, 3, m)
    return terms, weights, qt, qc


@pytest.mark.parametrize("seed", [0, 1])
def test_scores_kernel_matches_jax(seed, monkeypatch):
    terms, weights, qt, qc = _doc_major(seed)
    want = np.asarray(jops.bm25_scores_kernel(*map(jnp.asarray, (terms, weights, qt, qc))))
    # a small chunk, so the row chunking is exercised
    monkeypatch.setattr(tops, "SCAN_CHUNK_ELEMS", 5 * 16 * 97)
    got = tops.bm25_scores_kernel(*map(torch.from_numpy, (terms, weights, qt, qc)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _tie_slab(seed, b=6, n=2048):
    """Scores drawn from a handful of values, so the top-k crosses many
    exact ties, with -inf columns and one all -inf row."""
    rng = np.random.default_rng(seed)
    s = rng.choice(np.array([0.0, 1.5, 2.25, 3.0, 7.5], np.float32), (b, n))
    s[rng.random((b, n)) < 0.2] = -np.inf
    s[-1] = -np.inf
    s[0, :5] = 9.0
    return s.astype(np.float32)


@pytest.mark.parametrize("n,k", [(2048, 10), (2048, 300), (1000, 7), (1024, 600)])
def test_select_topk_ids_equal_jax_on_ties(n, k):
    s = _tie_slab(n, n=n)
    js, jp = (np.asarray(a) for a in jops.select_topk(jnp.asarray(s), k))
    ts, tp = tops.select_topk(torch.from_numpy(s), k)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tp.numpy(), jp)


def _hybrid_operands(seed, n=4096, h=6, nnz=3000, b=4):
    rng = np.random.default_rng(seed)
    w_head = (rng.random((h, n)) * (rng.random((h, n)) < 0.3)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-50:] = False
    width = 64
    tail_docs = np.concatenate([rng.integers(0, n - 50, nnz), np.zeros(width)]).astype(np.int32)
    tail_w = np.concatenate([rng.random(nnz) + 0.1, np.zeros(width)]).astype(np.float32)
    return rng, w_head, valid, tail_docs, tail_w, width, b, h


def _pack_flat(rng, b, h, widths, ss, nnz):
    q_head = rng.integers(0, 3, (b, h))
    parts = [q_head.reshape(-1)]
    for w, s in zip(widths, ss):
        live = s - 2  # two padding slabs per bucket
        starts = np.concatenate([rng.integers(0, nnz - w, live), [0, 0]])
        lens = np.concatenate([rng.integers(1, w + 1, live), [0, 0]])
        counts = np.concatenate([rng.integers(1, 3, live), [0, 0]])
        qids = np.concatenate([rng.integers(0, b, live), [0, 0]])
        parts += [starts, lens, counts, qids]
    return np.concatenate(parts).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_hybrid_flat_matches_jax(seed):
    rng, w_head, valid, tail_docs, tail_w, width, b, h = _hybrid_operands(seed)
    widths, ss = (16, width), (8, 16)
    packed = _pack_flat(rng, b, h, widths, ss, 3000)
    args = (w_head, valid, tail_docs, tail_w, packed)
    want = jops.bm25_hybrid_topk_flat(*map(jnp.asarray, args), 10, b, h, widths, ss)
    got = tops.bm25_hybrid_topk_flat(*map(torch.from_numpy, args), 10, b, h, widths, ss)
    _assert_topk_close(tuple(a.numpy() for a in got), tuple(np.asarray(a) for a in want))


@pytest.mark.parametrize("seed", [0, 1])
def test_hybrid_single_width_matches_jax(seed):
    rng, w_head, valid, tail_docs, tail_w, width, b, h = _hybrid_operands(seed)
    q_head = rng.integers(0, 3, (b, h)).astype(np.float32)
    t = 5
    starts = rng.integers(0, 3000 - width, (b, t)).astype(np.int32)
    lens = rng.integers(0, width + 1, (b, t)).astype(np.int32)
    counts = rng.integers(1, 3, (b, t)).astype(np.float32)
    args = (w_head, valid, q_head, tail_docs, tail_w, starts, lens, counts)
    want = jops.bm25_hybrid_topk(*map(jnp.asarray, args), 10, width)
    got = tops.bm25_hybrid_topk(*map(torch.from_numpy, args), 10, width)
    _assert_topk_close(tuple(a.numpy() for a in got), tuple(np.asarray(a) for a in want))


@pytest.mark.parametrize("seed", [0, 1])
def test_tail_only_matches_jax(seed):
    rng, _, _, tail_docs, tail_w, width, b, _ = _hybrid_operands(seed)
    widths, ts = (16, width), (3, 2)
    cols = []
    for w, t in zip(widths, ts):
        cols += [rng.integers(0, 3000 - w, (b, t)), rng.integers(0, w + 1, (b, t)),
                 rng.integers(1, 3, (b, t))]
    packed = np.concatenate(cols, axis=1).astype(np.int32)
    packed[-1] = 0  # an empty query: every slot padding
    for k in (10, 500):  # 500 > the candidate window: padded with (-inf, -1)
        want = jops.bm25_tail_only_topk(*map(jnp.asarray, (tail_docs, tail_w, packed)), k, widths, ts)
        got = tops.bm25_tail_only_topk(*map(torch.from_numpy, (tail_docs, tail_w, packed)), k, widths, ts)
        ws, wp = (np.asarray(a) for a in want)
        gs, gp = (a.numpy() for a in got)
        assert gs.shape == ws.shape == (b, k)
        _assert_topk_close((gs, gp), (ws, wp))
        assert (gp[-1] == -1).all() and np.isneginf(gs[-1]).all()


# -- the index ---------------------------------------------------------------


def _pair(csr, backend, **kw):
    j = JIndex(backend=backend, **kw)
    t = TIndex(backend=backend, device=CPU, **kw)
    j.build_from_csr(*csr)
    t.build_from_csr(*csr)
    return j, t


def _oracle_topk(csr, queries, k):
    """numpy_bm25_oracle on the CSR corpus as token lists."""
    docs = [d.split() for d in csr_texts(*csr[:3])]
    out = []
    for q in queries:
        want = tops.numpy_bm25_oracle(docs, q)
        out.append(np.sort(want)[::-1][:k])
    return np.asarray(out, np.float32)


def test_host_backend_matches_jax_and_oracle(csr):
    j, t = _pair(csr, "host")
    _, _, mixed = _queries(3, 16)
    got, want = t.search(mixed, 10), j.search(mixed, 10)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], _oracle_topk(csr, mixed, 10), rtol=1e-4, atol=1e-5)
    assert t.stats() == j.stats()


def test_hybrid_forced_to_device_matches_jax(csr):
    """host_budget=0: every query with an indexed term runs the device
    programs (head-carrying batches the flat program, head-free ones the
    tail-only program)."""
    j, t = _pair(csr, "hybrid", head_terms=48, host_budget=0)
    assert t.stats()["head_terms"] == j.stats()["head_terms"] == 48
    head, sel, mixed = _queries(4, 12)
    assert t._hybrid_operands(t._count_terms(sel))[0], "selective: the tail-only program"
    assert not t._hybrid_operands(t._count_terms(head))[0], "head: the flat program"
    for batch in (head, sel, mixed):
        _assert_topk_close(t.search(batch, 10), j.search(batch, 10))
    np.testing.assert_allclose(t.search(sel, 10)[0], _oracle_topk(csr, sel, 10),
                               rtol=1e-4, atol=1e-5)


def test_tail_only_program_zero_fill_matches_jax():
    """A head-free batch takes the tail-only program; its unmatched slots
    fill with the lowest unused doc ids at score 0, in rank order."""
    csr = synth_csr(np.random.default_rng(8), 2000, vocab=5000, mean_len=20)
    j, t = _pair(csr, "hybrid", host_budget=0)
    rare = [f"w{i}" for i in np.argsort(t._df, kind="stable") if t._df[i] > 0][:4]
    queries = [[rare[0]], [rare[1], rare[2]], ["zz_none"], [rare[3], rare[0]]]
    assert t._hybrid_operands(t._count_terms(queries))[0], "takes the tail-only program"
    gs, gp = t._hybrid_search(queries, 8)
    ws, wp = j._hybrid_search(queries, 8)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-5)
    assert (gs[:, -1] == 0).all() and (gp[2] == np.arange(8)).all()


def test_hybrid_routed_mixed_batch_matches_jax_and_host(csr):
    """The default router on a head / selective / zero-match batch, with a
    budget that sends the head queries to the device and the others to
    the host scorer."""
    j, t = _pair(csr, "hybrid", host_budget=N_DOCS)
    host = TIndex(backend="host", device=CPU)
    host.build_from_csr(*csr)
    _, _, mixed = _queries(5, 16)
    counts = t._count_terms(mixed)
    routed = [t._estimated_entries([c]) > N_DOCS for c in counts]
    assert any(routed) and not all(routed)
    got = t.search(mixed, 10)
    _assert_topk_close(got, j.search(mixed, 10))
    _assert_topk_close(got, host.search(mixed, 10))


def test_device_backend_matches_jax_and_oracle(csr):
    texts = csr_texts(*csr[:3])[:800]
    j = JIndex(backend="device")
    t = TIndex(backend="device", device=CPU)
    j.build_from_texts_native(texts)
    t.build_from_texts_native(texts)
    assert t.stats()["backend"] == "device" and t.stats()["dmax"] == j.stats()["dmax"]
    head, sel, mixed = _queries(6, 8)
    for batch in (head, sel, mixed):
        _assert_topk_close(t.search(batch, 10), j.search(batch, 10))
    docs = [d.split() for d in texts]
    np.testing.assert_allclose(t.get_scores(head[0]), tops.numpy_bm25_oracle(docs, head[0]),
                               rtol=1e-5, atol=1e-6)


def test_coalesced_batches_equal_solo_dispatches(csr):
    t = TIndex(backend="hybrid", head_terms=48, host_budget=0, device=CPU)
    t.build_from_csr(*csr)
    head, sel, _ = _queries(7, 6)
    batches = [head[:3], sel[:2], head[3:] + sel[2:3]]
    solo = [t.search(b, 10) for b in batches]
    pend = [t.search_dispatch(b, k) for b, k in zip(batches, (10, 4, 10))]
    assert len(t._dev_queue) == 3
    merged = [p.result() for p in pend]
    assert not t._dev_queue
    for (ms, mp), (ss, sp), k in zip(merged, solo, (10, 4, 10)):
        np.testing.assert_array_equal(mp, sp[:, :k])
        np.testing.assert_array_equal(ms, ss[:, :k])


def test_add_delete_rebuild_matches_jax():
    texts = csr_texts(*synth_csr(np.random.default_rng(2), 1100, vocab=300, mean_len=20)[:3])
    j = JRetriever.from_texts(texts[:950], k=5, backend="hybrid")
    t = TRetriever.from_texts(texts[:950], k=5, backend="hybrid", device=CPU)
    with pytest.warns(UserWarning, match="rebuild"):
        j.add_texts(texts[950:])
    with pytest.warns(UserWarning, match="rebuild"):
        t.add_texts(texts[950:])
    gone = [d.id for d in t.docs[:50]]
    assert t.delete(gone) and j.delete([d.id for d in j.docs[:50]])
    assert not t.delete(["no-such-id"])
    queries = [texts[i] for i in (60, 120, 250, 1000)]
    for q in queries:
        got = [(d.content, s) for d, s in t.get_top_k_with_scores(q, 5)]
        want = [(d.content, s) for d, s in j.get_top_k_with_scores(q, 5)]
        assert [c for c, _ in got] == [c for c, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-4)
    assert t.get_bm25_info()["num_documents"] == j.get_bm25_info()["num_documents"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_snapshot_loads_across_packages(tmp_path, writer):
    texts = csr_texts(*synth_csr(np.random.default_rng(3), 300, vocab=150, mean_len=20)[:3])
    path = tmp_path / "bm25.json"
    j = JRetriever.from_texts(texts, k=4, backend="hybrid")
    t = TRetriever.from_texts(texts, k=4, backend="hybrid", device=CPU)
    (j if writer == "jax" else t).save_to_disk(path)
    j2 = JRetriever.load_from_disk(path)
    t2 = TRetriever.load_from_disk(path, device=CPU)
    assert t2.index.backend == j2.index.backend == "hybrid"
    for q in texts[:6]:
        got = [(d.id, d.content) for d in t2.invoke(q)]
        assert got == [(d.id, d.content) for d in j2.invoke(q)]
        assert [d.content for d in t2.invoke(q)] == [d.content for d in t.invoke(q)]


def test_retriever_positions_and_dispatch_match_jax():
    texts = csr_texts(*synth_csr(np.random.default_rng(4), 300, vocab=150, mean_len=20)[:3])
    j = JRetriever.from_texts(texts, k=4)
    t = TRetriever.from_texts(texts, k=4, device=CPU)
    queries = texts[10:14]
    jf, tf = j.dispatch_positions(queries, k=6), t.dispatch_positions(queries, k=6)
    tf.prime()
    np.testing.assert_array_equal(tf()[1], jf()[1])
    assert t.position_space_size == j.position_space_size == 300
    got = t.dispatch_batch(queries, k=3)()
    assert [[d.content for d in r] for r in got] == [
        [d.content for d in r] for r in j.invoke_batch(queries, k=3)]
    rows = t.resolve_positions(np.array([[0, -1, 299, 300]]))
    assert rows[0][0].content == texts[0] and rows[0][1] is None and rows[0][3] is None


def test_device_is_required_and_mesh_raises():
    with pytest.raises(TypeError):
        TIndex(backend="host")  # no CPU default
    with pytest.raises(TypeError):
        TRetriever.from_texts(["a b"])
    with pytest.raises(NotImplementedError, match=r"Queue 1 \[#15\]"):
        TIndex(mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="backend"):
        TIndex(backend="gpu", device=CPU)
    with pytest.raises(ValueError, match="host/hybrid"):
        TIndex(backend="device", device=CPU).build_from_csr(
            np.array([0, 1]), np.array([0], np.int32), np.array([1.0], np.float32),
            np.array([1]))
