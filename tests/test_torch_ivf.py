"""Parity of the port's IVF path with the JAX package's on the CPU.

- k-means: the kmeans++ seeding bit-equal; on separated clusters the
  assignments equal and the centroids within 1e-5 (f32 sums in another
  order); deterministic under a seed.
- ``ops/ivf_scan.py::ivf_scan_plain`` against ``_ivf_search_body``'s
  scores on the same arrays (f32 / bf16 / int8, cosine / ip / l2), within
  ``ATOL`` (f32 sums in another order; the rounding points are the same).
- ``DeviceIVFIndex`` searches equal to the JAX index's for an index
  carried across by snapshot in both directions (spill 1 / 2 / 4, every
  dtype, nprobe 1 / 4 / nlist): ids equal up to ties at ``ATOL``, scores
  within ``ATOL``.
- the JAX package's single-device IVF cases (``tests/test_ivf.py``) on
  the port: add after training, deletes of every copy, take, compaction's
  remap, lmax growth, stats, the spill cap, k unique rows, the refusals;
  and the store's IVF cases (flat until the threshold, tombstones, int8
  staging, MMR, auto-compaction, ``auto`` → flat, a bad index type).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_arc_tpu.index import persistence as jpers
from rag_arc_tpu.index.ivf import DeviceIVFIndex as JaxIVF
from rag_arc_tpu.index.ivf import _ivf_search_body
from rag_arc_tpu.index.vector_store import TPUVectorStore
from rag_arc_tpu.models.embeddings import HashEmbeddings as JaxHash
from rag_arc_tpu.ops import kmeans as jkm
from rag_arc_tpu_torch.index import persistence as tpers
from rag_arc_tpu_torch.index.flat import DeviceFlatIndex as TorchFlat
from rag_arc_tpu_torch.index.ivf import DeviceIVFIndex as TorchIVF
from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
from rag_arc_tpu_torch.models.embeddings import HashEmbeddings
from rag_arc_tpu_torch.ops import kmeans as tkm
from rag_arc_tpu_torch.ops.ivf_scan import ivf_scan, ivf_scan_plain
from rag_arc_tpu_torch.ops.scoring import l2_normalize

ATOL = 2e-5  # f32 sums of up to 32 products in another order
DIM = 32
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def clustered(seed, n_clusters=8, per=40, dim=DIM, spread=0.05):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 3
    return np.concatenate([
        c + spread * rng.standard_normal((per, dim)).astype(np.float32) for c in centers
    ])


def sphere(seed, n, dim=DIM):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def assert_same_search(got, want, atol=ATOL):
    """Scores within ``atol``; ids equal except where the two rankings
    swap entries whose scores tie within ``atol``."""
    (ts, tp), (js, jp) = got, want
    np.testing.assert_array_equal(np.isneginf(ts), np.isneginf(js))
    fin = np.isfinite(js)
    np.testing.assert_allclose(ts[fin], js[fin], rtol=0, atol=atol)
    np.testing.assert_array_equal(tp[~fin], jp[~fin])
    for r, c in zip(*np.nonzero(tp != jp)):
        row = js[r]
        assert np.sum(np.abs(row - row[c]) <= atol) > 1, (r, c, tp[r], jp[r], row)
        kth = row[np.isfinite(row)].min()
        assert tp[r, c] in jp[r] or abs(row[c] - kth) <= atol, (r, tp[r], jp[r], row)


# -- k-means -------------------------------------------------------------------


def test_kmeans_pp_init_bit_equal():
    data = clustered(0)
    want = jkm._kmeans_pp_init(data, 8, np.random.default_rng(5))
    got = tkm._kmeans_pp_init(data, 8, np.random.default_rng(5))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_clusters,per,iters,seed", [(8, 50, 15, 1), (4, 30, 10, 0)])
def test_kmeans_separated_clusters_match_jax(n_clusters, per, iters, seed):
    data = clustered(seed, n_clusters=n_clusters, per=per)
    jc, ja = jkm.kmeans(data, n_clusters, n_iters=iters, seed=seed)
    tc, ta = tkm.kmeans(data, n_clusters, n_iters=iters, seed=seed, device="cpu")
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-5)
    assert ta.dtype == np.int32 and tc.dtype == np.float32
    for c in range(n_clusters):  # each true cluster lands in one learned one
        block = ta[c * per : (c + 1) * per]
        assert (block == block[0]).all()


def test_kmeans_deterministic_and_too_few_points():
    data = clustered(3, n_clusters=16, per=20)
    c1, a1 = tkm.kmeans(data, 8, seed=3, device="cpu")
    c2, a2 = tkm.kmeans(data, 8, seed=3, device="cpu")
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(c1, c2)
    with pytest.raises(ValueError, match="at least"):
        tkm.kmeans(data[:5], 8, device="cpu")


# -- the probe scan ------------------------------------------------------------


def _scan_arrays(dtype, metric, seed=0, nlist=6, lmax=24, b=5, nprobe=3):
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    centroids = rng.standard_normal((nlist, DIM)).astype(np.float32)
    if dtype == "int8":
        lists = rng.integers(-127, 128, (nlist, lmax, DIM)).astype(np.int8)
        sqnorm = (rng.random((nlist, lmax)) * 0.01).astype(np.float32)
    else:
        lists = rng.standard_normal((nlist, lmax, DIM)).astype(np.float32)
        if dtype == "bf16":  # values the bf16 storage holds exactly
            lists = np.array(jnp.asarray(lists, jnp.bfloat16).astype(jnp.float32))
        sqnorm = (lists * lists).sum(axis=2).astype(np.float32)
    valid = rng.random((nlist, lmax)) > 0.2
    pos = np.arange(nlist * lmax, dtype=np.int32).reshape(nlist, lmax)
    q = rng.standard_normal((b, DIM)).astype(np.float32)
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    return jdt, tdt, centroids, lists, sqnorm, valid, pos, q


@pytest.mark.parametrize("dtype,metric", [
    ("f32", "cosine"), ("f32", "ip"), ("f32", "l2"), ("bf16", "cosine"), ("bf16", "ip"),
    ("bf16", "l2"), ("int8", "cosine"), ("int8", "ip")])
def test_ivf_scan_plain_matches_search_body(dtype, metric):
    jdt, tdt, centroids, lists, sqnorm, valid, pos, q = _scan_arrays(dtype, metric)
    nlist, lmax, _ = lists.shape
    nprobe = 3
    # every probed score: the body's top-k at k = nprobe·Lmax
    js, jp = _ivf_search_body(
        jnp.asarray(centroids), jnp.asarray(lists, jdt), jnp.asarray(sqnorm),
        jnp.asarray(valid), jnp.asarray(pos), jnp.ones(nlist, bool), jnp.asarray(q),
        nprobe * lmax, nprobe, metric)
    js, jp = np.asarray(js), np.asarray(jp)
    # the same probe selection, then the port's scan
    qt = torch.from_numpy(q)
    if metric == "cosine":
        qt = l2_normalize(qt)
    ct = torch.from_numpy(centroids)
    cross = qt @ ct.T
    c_scores = 2.0 * cross - (ct * ct).sum(1) if metric == "l2" else cross
    probe = torch.sort(c_scores, dim=1, descending=True, stable=True)[1][:, :nprobe]
    args = (qt, probe, torch.from_numpy(lists).to(tdt), torch.from_numpy(sqnorm),
            torch.from_numpy(valid), metric, cross if dtype == "int8" else None)
    got = ivf_scan_plain(*args).numpy()
    np.testing.assert_array_equal(ivf_scan(*args).numpy(), got)  # CPU: the plain version
    got_pos = pos[probe.numpy()].reshape(len(q), -1)
    dense_t = np.full((len(q), nlist * lmax), -np.inf, np.float32)
    dense_j = np.full_like(dense_t, -np.inf)
    for r in range(len(q)):
        dense_t[r, got_pos[r]] = got[r]
        fin = np.isfinite(js[r])
        dense_j[r, jp[r][fin]] = js[r][fin]
    np.testing.assert_array_equal(np.isneginf(dense_t), np.isneginf(dense_j))
    fin = np.isfinite(dense_j)
    assert fin.sum() > 0
    np.testing.assert_allclose(dense_t[fin], dense_j[fin], rtol=0, atol=ATOL * 8)


def test_ivf_scan_checks_its_inputs():
    _, tdt, _, lists, sqnorm, valid, _, q = _scan_arrays("int8", "ip")
    args = (torch.from_numpy(q), torch.zeros((len(q), 2), dtype=torch.int64),
            torch.from_numpy(lists), torch.from_numpy(sqnorm), torch.from_numpy(valid))
    with pytest.raises(ValueError, match="cross"):
        ivf_scan(*args, "ip")
    with pytest.raises(ValueError, match="l2"):
        ivf_scan(*args, "l2", torch.zeros((len(q), lists.shape[0])))
    with pytest.raises(ValueError, match="queries"):
        ivf_scan(args[0][:, :5], *args[1:], "ip", torch.zeros((len(q), lists.shape[0])))


# -- searches on an index carried across by snapshot ----------------------------


def _jax_store(index, spill=1, cap=1.25):
    store = TPUVectorStore(JaxHash(dim=DIM), dim=DIM, index_type="ivf", nlist=index.nlist,
                           nprobe=index.nprobe, ivf_spill=spill, ivf_spill_cap=cap,
                           metric=index.metric)
    store.index = index
    return store


def _torch_store(index, spill=1, cap=1.25):
    store = TorchVectorStore(HashEmbeddings(dim=DIM), dim=DIM, index_type="ivf",
                             nlist=index.nlist, nprobe=index.nprobe, ivf_spill=spill,
                             ivf_spill_cap=cap, metric=index.metric, device="cpu")
    store.index = index
    return store


def to_port(jidx, path, dtype=None):
    jpers.save_store(_jax_store(jidx, jidx.spill, jidx.spill_cap), path)
    return tpers.load_store(path, HashEmbeddings(dim=DIM), dtype=dtype, device="cpu").index


def to_jax(tidx, path):
    tpers.save_store(_torch_store(tidx, tidx.spill, tidx.spill_cap), path)
    return jpers.load_store(path, JaxHash(dim=DIM)).index


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("spill", [1, 2, 4])
def test_search_parity_across_snapshots(direction, dtype, spill, tmp_path):
    data = sphere(spill, 480)
    q = sphere(10 + spill, 7)
    jdt, tdt = DTYPES[dtype]
    kw = dict(nlist=8, nprobe=4, spill=spill, metric="cosine")
    if direction == "jax_to_port":
        j = JaxIVF.from_vectors(data, dtype=jdt, **kw)
        # a JAX snapshot holds float lists as f32; load them as the JAX
        # index stores them
        t = to_port(j, tmp_path / "s", dtype=None if dtype == "int8" else tdt)
        assert t.dtype == tdt
    else:
        t = TorchIVF.from_vectors(data, dtype=tdt, device="cpu", **kw)
        j = to_jax(t, tmp_path / "s")
        if dtype == "bf16":  # the JAX package reloads float lists as f32
            t = to_port(j, tmp_path / "back")
    assert t.lmax == j.lmax and t.size == j.size
    # the same lists hold each row (a loaded index calls the lowest list
    # its primary, a built one the nearest)
    def lists_of(idx):
        extra = [idx._pos_xcluster] if idx.spill > 1 else []
        return np.sort(np.column_stack([idx._pos_cluster, *extra]), axis=1)

    np.testing.assert_array_equal(lists_of(t), lists_of(j))
    for nprobe in (1, 4, 8):
        assert_same_search(t.search(q, 10, nprobe=nprobe), j.search(q, 10, nprobe=nprobe))


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_search_parity_other_metrics_and_small_k(metric, tmp_path):
    data = clustered(4, per=30)
    j = JaxIVF.from_vectors(data, nlist=8, nprobe=3, metric=metric)
    t = to_port(j, tmp_path / "s")
    q = data[::37] + 0.01
    for k in (1, 5, 400):  # 400 > what 1 probed list holds: -inf / -1 padding
        assert_same_search(t.search(q, k, nprobe=1), j.search(q, k, nprobe=1),
                           atol=1e-4)


# -- the JAX package's single-device cases ----------------------------------------


def _both(data, tmp_path, **kw):
    j = JaxIVF.from_vectors(data, **{k: DTYPES[v][0] if k == "dtype" else v
                                     for k, v in kw.items()})
    return j, to_port(j, tmp_path / "carry")


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_add_after_training(dtype, tmp_path):
    data = clustered(0, per=30)
    j, t = _both(data, tmp_path, nlist=8, nprobe=8, dtype=dtype)
    new = np.concatenate([data[3:4] + 0.001, data[100:140] * 1.01])
    np.testing.assert_array_equal(t.add(new), j.add(new))
    assert t.size == j.size and t.lmax == j.lmax
    np.testing.assert_array_equal(t._fill, j._fill)
    _, got = t.search(new[:1], 2)
    assert set(got[0]) == {3, len(data)}
    assert_same_search(t.search(data[::9], 5), j.search(data[::9], 5), atol=1e-4)


@pytest.mark.parametrize("spill", [1, 2])
def test_delete_clears_every_copy(spill, tmp_path):
    data = clustered(1, n_clusters=4, per=40)
    j, t = _both(data, tmp_path, nlist=4, nprobe=4, spill=spill)
    _, got = t.search(data[11:12], 1)
    assert got[0, 0] == 11
    for idx in (t, j):
        idx.mark_deleted(np.array([11, 11, 12, -1, 10_000]))
        idx.mark_deleted(np.array([11]))
    assert t.n_deleted == j.n_deleted == 2 and t.n_active == len(data) - 2
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    _, got = t.search(data[11:12], 5)
    assert 11 not in set(got[0].tolist())
    assert_same_search(t.search(data[::7], 6), j.search(data[::7], 6))


def test_take(tmp_path):
    data = clustered(2, n_clusters=4, per=10)
    t = TorchIVF.from_vectors(data, nlist=4, metric="ip", device="cpu")
    np.testing.assert_allclose(t.take(np.array([5, 17])), data[[5, 17]], rtol=1e-5)
    j, t8 = _both(data, tmp_path, nlist=4, metric="ip", dtype="int8")
    np.testing.assert_allclose(t8.take(np.arange(40)), j.take(np.arange(40)), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("spill", [1, 2])
def test_compact_remaps_positions(spill, tmp_path):
    data = clustered(3, n_clusters=4, per=30)
    j, t = _both(data, tmp_path, nlist=4, nprobe=4, spill=spill)
    for idx in (t, j):
        idx.mark_deleted(np.arange(0, 120, 2))
    tm, jm = t.compact(), j.compact()
    assert tm == jm == {old: new for new, old in enumerate(range(1, 120, 2))}
    assert t.n_active == 60 and t.n_deleted == 0 and t.lmax == j.lmax
    _, p = t.search(data[31:32], 1)
    assert p[0, 0] == tm[31]
    assert_same_search(t.search(data[1::11], 4), j.search(data[1::11], 4))


def test_grow_lmax_on_device(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((256, 16)).astype(np.float32)
    j = JaxIVF.from_vectors(data, nlist=16, nprobe=16)
    jpers.save_store(TPUVectorStore(JaxHash(dim=16), dim=16, index_type="ivf", nlist=16,
                                    nprobe=16, index=j), tmp_path / "s")
    t = tpers.load_store(tmp_path / "s", HashEmbeddings(dim=16), device="cpu").index
    lmax0 = t.lmax
    skew = np.tile(data[0], (lmax0 * 2, 1)) + 0.001 * rng.standard_normal(
        (lmax0 * 2, 16)).astype(np.float32)
    t.add(skew)
    j.add(skew)
    assert t.lmax == j.lmax > lmax0
    _, got = t.search(data[0][None, :], 1)
    assert got[0, 0] == 0
    assert_same_search(t.search(data[:9], 3), j.search(data[:9], 3))


def test_stats_equal(tmp_path):
    data = clustered(5, n_clusters=4, per=10)
    for dtype in ("f32", "int8"):
        j, t = _both(data, tmp_path / dtype, nlist=4, dtype=dtype)
        ts, js = t.stats(), j.stats()
        assert ts["device"] == "cpu"
        assert {k: ts[k] for k in js} == js


def test_spill_cap_bounds_lmax_and_delete_skips_dropped(tmp_path):
    data = sphere(6, 1024)
    j, tight = _both(data, tmp_path, nlist=16, nprobe=16, spill=3, spill_cap=1.05)
    loose = TorchIVF.from_vectors(data, nlist=16, nprobe=16, spill=3, spill_cap=16.0,
                                  device="cpu")
    assert tight.lmax <= loose.lmax
    assert (tight._pos_xcluster == -1).any() and (tight._pos_cluster >= 0).all()
    _, got = tight.search(data[:16], 1)
    assert set(got[:, 0].tolist()) == set(range(16))
    victim = int(np.argmax((tight._pos_xcluster == -1).any(axis=1)))
    for idx in (tight, j):
        idx.mark_deleted(np.asarray([victim]))
    _, got2 = tight.search(data[victim][None], 1)
    assert got2[0, 0] != victim
    assert_same_search(tight.search(data[:16], 3), j.search(data[:16], 3))
    # compaction re-inserts under the same cap
    mapping = tight.compact()
    assert len(mapping) == 1023 and tight.lmax <= 2 * j.lmax
    # a bulk build on the port applies the same cap
    built = TorchIVF.from_vectors(data, nlist=16, nprobe=16, spill=3, spill_cap=1.05,
                                  device="cpu")
    assert (built._pos_cluster >= 0).all() and (built._pos_xcluster == -1).any()


@pytest.mark.parametrize("spill", [3, 4])
def test_spill_returns_k_unique_rows(spill):
    data = sphere(7, 600, dim=64)
    t = TorchIVF.from_vectors(data, nlist=8, nprobe=8, spill=spill, device="cpu")
    _, got = t.search(data[:16], 5, nprobe=8)
    for row in got:
        assert (row >= 0).all() and len(set(row.tolist())) == 5, row


def test_exhaustive_probe_equals_flat():
    data = clustered(8)
    q = sphere(9, 8)
    flat = TorchFlat(dim=DIM, capacity=1024, device="cpu")
    flat.add(data)
    fs, fp = flat.search(q, 10)
    for spill in (1, 2):
        t = TorchIVF.from_vectors(data, nlist=8, nprobe=2, spill=spill, device="cpu")
        assert_same_search(t.search(q, 10, nprobe=8), (fs, fp))


def test_refusals():
    with pytest.raises(ValueError, match="l2"):
        TorchIVF(dim=8, dtype=torch.int8, metric="l2", device="cpu")
    with pytest.raises(NotImplementedError, match=r"\[#15\]"):
        TorchIVF(dim=8, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="spill"):
        TorchIVF(dim=8, spill=5, device="cpu")
    with pytest.raises(RuntimeError, match="untrained"):
        TorchIVF(dim=8, device="cpu").add(np.zeros((1, 8), np.float32))
    with pytest.raises(ValueError, match="training vectors"):
        TorchIVF.from_vectors(np.ones((4, 8), np.float32), nlist=8, device="cpu")
    s, p = TorchIVF(dim=8, device="cpu").search(np.zeros((2, 8), np.float32), 3)
    assert np.isneginf(s).all() and (p == -1).all()
    with pytest.raises(ValueError, match="l2"):
        TorchVectorStore(HashEmbeddings(dim=8), index_type="ivf", dtype=torch.int8,
                         metric="l2", device="cpu")


# -- the store ---------------------------------------------------------------------


def _stores(**kw):
    jkw = dict(kw)
    if "dtype" in jkw:
        jkw["dtype"] = {torch.int8: jnp.int8}[jkw["dtype"]]
    return (TPUVectorStore(JaxHash(dim=DIM), **jkw),
            TorchVectorStore(HashEmbeddings(dim=DIM), device="cpu", **kw))


def _ids(hits):
    return [[d.id for d, _ in h] for h in hits]


@pytest.mark.parametrize("dtype", [None, torch.int8])
def test_store_flat_until_threshold_then_ivf_with_tombstones(dtype):
    kw = dict(index_type="ivf", nlist=8, nprobe=8, train_threshold=20)
    if dtype is not None:
        kw["dtype"] = dtype
    j, t = _stores(**kw)
    texts = [f"early doc {i} alpha" for i in range(10)]
    for store in (j, t):
        store.add_texts(texts, ids=[f"e{i}" for i in range(10)])
    assert isinstance(t.index, TorchFlat)
    assert t.similarity_search("early doc 3 alpha", k=1)[0].content == "early doc 3 alpha"
    for store in (j, t):
        store.delete(["e4"])
        store.add_texts([f"later doc {i} beta" for i in range(15)],
                        ids=[f"l{i}" for i in range(15)])
    assert t.index.stats()["kind"] == "ivf" and t.index.dtype == (dtype or torch.float32)
    assert t.similarity_search("early doc 3 alpha", k=1)[0].content == "early doc 3 alpha"
    assert t.similarity_search("later doc 7 beta", k=1)[0].content == "later doc 7 beta"
    assert "early doc 4 alpha" not in [
        d.content for d in t.similarity_search("early doc 4 alpha", k=24)]
    queries = texts[:6] + ["later doc 2 beta", "later doc 9 beta"]
    assert _ids(t.batch_similarity_search_with_score(queries, k=4)) == _ids(
        j.batch_similarity_search_with_score(queries, k=4))


def test_store_int8_staging_converts_cleanly():
    from rag_arc_tpu_torch.utils.data_model import Document

    store = TorchVectorStore(HashEmbeddings(dim=DIM), dim=DIM, index_type="ivf", nlist=8,
                             train_threshold=150, dtype=torch.int8, device="cpu")
    store.add_documents([Document(content=f"row {i} group {i % 6}") for i in range(160)])
    assert store.index.stats()["kind"] == "ivf" and store.index.quantized
    assert store.similarity_search("row 42 group 0", k=3)[0].content == "row 42 group 0"


def test_store_mmr_and_multi_query_on_ivf():
    j, t = _stores(index_type="ivf", nlist=4, train_threshold=8)
    for store in (j, t):
        store.add_texts([f"topic {i} words here" for i in range(12)],
                        ids=[f"d{i}" for i in range(12)])
    docs = t.max_marginal_relevance_search("topic 3", k=2, fetch_k=6)
    assert [d.id for d in docs] == [
        d.id for d in j.max_marginal_relevance_search("topic 3", k=2, fetch_k=6)]
    assert len(docs) == 2
    variants = [["topic 1", "topic 1 words"], ["topic 7"]]
    assert _ids(t.multi_query_search(variants, k=3, k_per_variant=5)) == _ids(
        j.multi_query_search(variants, k=3, k_per_variant=5))


def test_store_autocompacts_ivf():
    j, t = _stores(index_type="ivf", nlist=4, train_threshold=10, compact_threshold=0.3)
    texts = [f"doc number {i} alpha beta" for i in range(30)]
    ids = t.add_texts(texts)
    j.add_texts(texts, ids=ids)
    assert t.index.stats()["kind"] == "ivf"
    t.delete(ids[:15])
    j.delete(ids[:15])
    assert t.index.n_deleted == 0 and t.index.n_active == 15
    assert t.similarity_search(texts[20], k=1)[0].content == texts[20]
    assert _ids(t.batch_similarity_search_with_score(texts[14:22], k=3)) == _ids(
        j.batch_similarity_search_with_score(texts[14:22], k=3))


def test_store_index_type_auto_and_bad():
    store = TorchVectorStore(HashEmbeddings(dim=8), index_type="auto", device="cpu")
    assert store.index_type == "flat" and isinstance(store.index, TorchFlat)
    with pytest.raises(ValueError, match="index_type"):
        TorchVectorStore(HashEmbeddings(dim=8), index_type="annoy", device="cpu")


def test_store_ivf_snapshot_round_trip_both_ways(tmp_path):
    j, t = _stores(index_type="ivf", nlist=8, nprobe=8, ivf_spill=2, train_threshold=100)
    texts = [f"doc {i} topic {i % 5}" for i in range(300)]
    ids = [f"d{i}" for i in range(300)]
    j.add_texts(texts, ids=ids)
    jpers.save_store(j, tmp_path / "j")
    t = tpers.load_store(tmp_path / "j", HashEmbeddings(dim=DIM), device="cpu")
    assert t.index.spill == 2 and t.ivf_spill == 2 and t.kf_mult == j.kf_mult
    q = texts[40:48]
    assert _ids(t.batch_similarity_search_with_score(q, k=5)) == _ids(
        j.batch_similarity_search_with_score(q, k=5))
    for store in (j, t):
        store.delete(["d42"])
    assert "d42" not in _ids(t.batch_similarity_search_with_score(q, k=5))[2]
    tpers.save_store(t, tmp_path / "t")
    back = jpers.load_store(tmp_path / "t", JaxHash(dim=DIM))
    again = tpers.load_store(tmp_path / "t", HashEmbeddings(dim=DIM), device="cpu")
    for store in (back, again):
        assert store.index.n_deleted == 1
        assert _ids(store.batch_similarity_search_with_score(q, k=5)) == _ids(
            j.batch_similarity_search_with_score(q, k=5))
    with pytest.raises(ValueError, match="float IVF lists"):
        tpers.load_store(tmp_path / "t", HashEmbeddings(dim=DIM), dtype=torch.int8,
                         device="cpu")
