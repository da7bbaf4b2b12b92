"""Parity of the port's int8 flat index with the JAX package on the CPU:
quantization (bit-equal, half-to-even ties included), the int8 sub-tile
producers against both TPU kernels (Pallas interpret mode, exact), the
quantized two-level top-k, ``DeviceFlatIndex(dtype=int8)`` on both of its
paths against the JAX index on its direct and certified-stream paths, the
int8 ``TorchVectorStore``, and snapshots loaded across the packages.

Inputs are numpy arrays made from a seed and handed to both packages.
Ids must be equal; scores agree within 1e-5 in the cosine range (ip
scores are that times ‖q‖), since the f32 rescore sums in another order.
"""

import functools
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rag_arc_tpu.index import persistence as jpers
from rag_arc_tpu.index.flat import DeviceFlatIndex as JaxFlat
from rag_arc_tpu.index.vector_store import TPUVectorStore
from rag_arc_tpu.models.embeddings import HashEmbeddings
from rag_arc_tpu.ops import two_level as jtl
from rag_arc_tpu_torch.index import persistence as tpers
from rag_arc_tpu_torch.index.flat import QUANT_BLOCK
from rag_arc_tpu_torch.index.flat import DeviceFlatIndex as TorchFlat
from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
from rag_arc_tpu_torch.ops import subtile_max_i8 as smi8
from rag_arc_tpu_torch.ops import two_level as ttl

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- quantization ---------------------------------------------------------------


def test_round_half_to_even_agrees():
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5], np.float32)
    want = np.array([0, 2, 2, 0, -2, -2, 126], np.float32)
    np.testing.assert_array_equal(np.rint(ties), want)
    np.testing.assert_array_equal(np.asarray(jnp.round(jnp.asarray(ties))), want)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(ties)).numpy(), want)


def _tie_rows(n, d, seed):
    """Random rows, plus rows whose amax is 127 (scale exactly 1.0) and
    whose other values sit exactly on .5."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 126.5]
    x[0, 6:] = 0.0
    x[1] = 0.0  # an all-zero row: scale floor 1e-12/127
    return x


def test_quantize_rows_bit_equal():
    x = _tie_rows(70, 32, 0)
    jc, js = jtl.quantize_rows(x)
    tc, ts = ttl.quantize_rows(x)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tc[0, :6], [127, 2, -4, 0, 0, 126])


@pytest.mark.parametrize("n", [64, 70])  # 70: the pad up to a block multiple
def test_quantize_rows_blocked_bit_equal(n):
    x = _tie_rows(n, 32, 1)
    x[2:32] = np.clip(x[2:32], -100, 100)  # block 0's amax stays row 0's 127
    jc, js = jtl.quantize_rows_blocked(x, 32)
    tc, ts = ttl.quantize_rows_blocked(x, 32)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts, js)
    assert ts[0] == 1.0 and tc.shape[0] % 32 == 0
    np.testing.assert_array_equal(tc[0, :6], [127, 2, -4, 0, 0, 126])


@pytest.mark.parametrize("d", [32, 64])
def test_quantize_queries_bit_equal(d):
    rng = np.random.default_rng(d)
    q = 3.0 * rng.standard_normal((40, d)).astype(np.float32)
    # ‖q‖ = 128 exactly, so q/‖q‖ and the scale 1/128 are exact and the
    # codes land on the .5 ties 15.5 → 16, 3.5 → 4, -1.5 → -2, 0.5 → 0
    q[0] = 0.0
    q[0, :5] = [127.0, -15.5, 3.5, -1.5, 0.5]
    q[1] = 0.0  # a zero query
    jc, js = jtl.quantize_queries(jnp.asarray(q))
    tc, ts = ttl.quantize_queries(torch.from_numpy(q))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tc.dtype == torch.int8
    np.testing.assert_array_equal(tc[0, :5].numpy(), [127, -16, 4, -2, 0])


# -- producers -----------------------------------------------------------------


def _i8_data(seed, n=4096, d=64, b=8, per_row=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[300:304] = x[299]  # duplicates inside one block and across blocks
    x[1700] = x[299]
    codes, scales = (jtl.quantize_rows(x) if per_row
                     else jtl.quantize_rows_blocked(x, QUANT_BLOCK))
    valid = np.ones(n, bool)
    valid[5] = False
    valid[2048:2080] = False  # whole dead sub-tiles at g = 16 and 32
    valid[rng.integers(0, n, 60)] = False
    codes[~valid] = 0  # the index layer's invariant
    q = rng.standard_normal((b, d)).astype(np.float32)
    q[0] = x[299]
    return q, codes, scales, valid


def _jax_i8_submax(q_i8, codes, scales, valid, g, block_scales, tile_n=1024):
    """two_level_topk_i8's pass 1 on its own, as it launches it, in
    interpret mode → (N/g, B)."""
    n, d = codes.shape
    b = q_i8.shape[0]
    n_sub = n // g
    spec = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
    if block_scales:
        kernel = functools.partial(jtl._subtile_max_kernel_i8_block, g=g)
        scale_col, scale_spec = scales.reshape(n_sub, g)[:, :1], spec((tile_n // g, 1), lambda i, j: (i, 0))
    else:
        kernel = functools.partial(jtl._subtile_max_kernel_i8, g=g)
        scale_col, scale_spec = scales.reshape(n_sub, g), spec((tile_n // g, g), lambda i, j: (i, 0))
    return pl.pallas_call(
        kernel,
        grid=(n // tile_n, 1),
        in_specs=[
            spec((b, d), lambda i, j: (j, 0)),
            spec((tile_n, d), lambda i, j: (i, 0)),
            scale_spec,
            spec((tile_n // g, g), lambda i, j: (i, 0)),
        ],
        out_specs=spec((tile_n // g, b), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((n_sub, b), jnp.float32),
        interpret=True,
    )(jnp.asarray(q_i8), jnp.asarray(codes), jnp.asarray(scale_col),
      jnp.asarray(valid.astype(np.int8).reshape(n_sub, g)))


@pytest.mark.parametrize("block_scales", [True, False])
@pytest.mark.parametrize("g", [16, 32])
def test_producer_matches_tpu_kernel_exactly(block_scales, g):
    q, codes, scales, valid = _i8_data(0, per_row=not block_scales)
    q_i8, _ = ttl.quantize_queries(torch.from_numpy(q))
    got = smi8.subtile_max_i8(
        q_i8, torch.from_numpy(codes), torch.from_numpy(scales),
        torch.from_numpy(valid), g, block_scales=block_scales,
    ).numpy()
    want = np.asarray(_jax_i8_submax(q_i8.numpy(), codes, scales, valid, g, block_scales))
    np.testing.assert_array_equal(got, want.T)  # exact: integer dots, one multiply
    assert (got[:, 2048 // g] == np.float32(smi8.NEG)).all()


def test_cpu_wrapper_takes_plain_version_without_counting():
    q, codes, scales, valid = _i8_data(1)
    args = (ttl.quantize_queries(torch.from_numpy(q))[0], torch.from_numpy(codes),
            torch.from_numpy(scales), torch.from_numpy(valid), 16)
    before = smi8.launches
    out = smi8.subtile_max_i8(*args)
    assert smi8.launches == before
    np.testing.assert_array_equal(out.numpy(), smi8.subtile_max_i8_plain(*args).numpy())


@pytest.mark.parametrize(
    "bad, match",
    [(dict(g=48), "g must be"), (dict(n=1000), "multiple of g"),
     (dict(d=1056), "1040"), (dict(qdtype=torch.float32), "int8")],
)
def test_wrapper_refuses(bad, match):
    n, d = bad.get("n", 1024), bad.get("d", 32)
    q = torch.zeros((2, d), dtype=bad.get("qdtype", torch.int8))
    with pytest.raises(ValueError, match=match):
        smi8.subtile_max_i8(q, torch.zeros((n, d), dtype=torch.int8), torch.ones(n),
                            torch.ones(n, dtype=torch.bool), bad.get("g", 16))


@pytest.mark.parametrize("block_scales", [True, False])
@pytest.mark.parametrize("b", [1, 8])
def test_two_level_topk_i8_matches_jax(block_scales, b):
    q, codes, scales, valid = _i8_data(2, b=b, per_row=not block_scales)
    js, jp = jtl.two_level_topk_i8(
        jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(valid),
        k=10, g=16, tile_n=1024, interpret=True, block_scales=block_scales,
    )
    ts, tp = ttl.two_level_topk_i8(
        torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(scales),
        torch.from_numpy(valid), 10, g=16, block_scales=block_scales,
    )
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if block_scales:  # row 299 and its copies 300-303 share a block: a tie
        first = tp[0].tolist().index(299)
        assert tp[0, first : first + 5].tolist() == [299, 300, 301, 302, 303]


# -- the int8 flat index ---------------------------------------------------------


def _corpus(seed, n=1037, d=32):
    """Rows with copies inside one quantization block (39 → 40-43) and
    across blocks (500, and 900 in the same direction)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d)).astype(np.float32)
    v[40:44] = v[39]
    v[500] = v[39]
    v[900] = v[39] * 3.0  # same direction: a cosine tie
    q = rng.standard_normal((6, d)).astype(np.float32)
    q[0] = v[39]
    q[1] = v[700]
    return v, q


def _pair(path, refine, metric, capacity=1024, dim=32):
    j = JaxFlat(dim=dim, metric=metric, capacity=capacity, dtype=jnp.int8, refine=refine)
    t = TorchFlat(dim=dim, metric=metric, capacity=capacity, dtype=torch.int8,
                  refine=refine, device="cpu")
    j._force_stream = path == "two_level"
    t._force_two_level = path == "two_level"
    return j, t


def _same_state(j, t):
    assert (t.capacity, t.size, t.n_active, t.n_deleted, t._gap_rows, t._tail_scale) == (
        j.capacity, j.size, j.n_active, j.n_deleted, j._gap_rows, j._tail_scale)
    assert t.refine == j.refine
    names = ["emb", "sqnorm", "valid"] + (["res", "res_scale"] if t.refine else [])
    for name in names:
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    rows = np.arange(0, t.size, 7)
    np.testing.assert_array_equal(t.take(rows), j.take(rows))


def _same_search(j, t, q, k=10):
    js, jp = j.search(q, k)
    ts, tp = t.search(q, k)
    np.testing.assert_array_equal(tp, jp)
    qn = np.linalg.norm(q, axis=1, keepdims=True) if t.metric == "ip" else 1.0
    np.testing.assert_allclose(ts, js, rtol=0, atol=ATOL * np.max(qn))
    return tp


@pytest.mark.parametrize("metric", ["cosine", "ip"])
@pytest.mark.parametrize("refine", [None, "int4", "int8"])
@pytest.mark.parametrize("path", ["direct", "two_level"])
def test_index_matches_jax(path, refine, metric):
    v, q = _corpus(0)
    j, t = _pair(path, refine, metric)
    for lo, hi in ((0, 1), (1, 6), (6, 37), (37, 1037)):  # tail fill + gap rows
        j.add(v[lo:hi])
        t.add(v[lo:hi])
    assert t._gap_rows > 0 and t.capacity == 2048
    _same_state(j, t)
    tp = _same_search(j, t, q)
    for idx in (j, t):
        idx.mark_deleted(np.arange(100, 140))
        idx.mark_deleted(np.array([120, 41]))  # 120 again: counted once
    _same_state(j, t)
    tp = _same_search(j, t, q)
    assert not set(tp.ravel()) & (set(range(100, 140)) | {41})
    assert t.compact() == j.compact()
    _same_state(j, t)
    more, _ = _corpus(1, n=2500)
    j.add(more)
    t.add(more)   # past capacity 2048: both grow the same
    assert t.capacity == j.capacity == 8192
    _same_state(j, t)
    _same_search(j, t, q)


@pytest.mark.parametrize("refine", [None, "int4"])
def test_two_level_and_direct_paths_agree(refine):
    # the two-level path is exact under the quantized metric: the same
    # ids as the direct path, equal scores in the same order
    v, q = _corpus(2)
    direct = TorchFlat(dim=32, capacity=2048, dtype=torch.int8, refine=refine, device="cpu")
    direct.add(v)
    direct.mark_deleted(np.arange(10, 30))
    s1, p1 = direct.search(q, 10)
    direct._force_two_level = True
    s2, p2 = direct.search(q, 10)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_allclose(s1, s2, rtol=0, atol=ATOL)


def test_rescore_and_kf_mult_pass_through():
    v, q = _corpus(3)
    for kw in (dict(rescore_i8=False, refine=None), dict(kf_mult=4)):
        j = JaxFlat(dim=32, capacity=2048, dtype=jnp.int8, **kw)
        t = TorchFlat(dim=32, capacity=2048, dtype=torch.int8, device="cpu", **kw)
        j.add(v)
        t.add(v)
        assert t._kf(10) == j._kf_local(10, j.capacity)
        _same_search(j, t, q)


def test_fewer_live_rows_than_k():
    v, q = _corpus(4)
    v = v[:5]
    j, t = _pair("two_level", "int4", "cosine")
    j.add(v)
    t.add(v)
    tp = _same_search(j, t, q, k=8)
    assert (tp[:, 5:] == -1).all()


def test_option_errors_match():
    for kw, match in ((dict(metric="l2"), "cosine/ip"), (dict(refine="int4", dim=33), "even dim"),
                      (dict(kf_mult=0), "kf_mult"), (dict(refine="int2"), "refine")):
        kw = {"dim": 32, **kw}
        with pytest.raises(ValueError, match=match):
            TorchFlat(dtype=torch.int8, device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            JaxFlat(dtype=jnp.int8, **kw)
    assert TorchFlat(dim=33, dtype=torch.int8, device="cpu").refine == "int8"
    assert TorchFlat(dim=32, dtype=torch.bfloat16, device="cpu").refine is None


def test_stats_match():
    v, _ = _corpus(5)
    j, t = _pair("direct", "int4", "cosine")
    j.add(v[:40])
    t.add(v[:40])
    js, ts = j.stats(), t.stats()
    for key in ("kind", "dim", "metric", "capacity", "size", "active", "deleted",
                "gap_rows", "shards", "refine", "hbm_bytes"):
        assert ts[key] == js[key], key
    assert ts["dtype"] == "int8"


# -- the store and snapshots -------------------------------------------------------


def _texts(n):
    return [f"doc {i} about topic {i % 7} flavor {i * 13 % 11}" for i in range(n)]


def _stores(refine="default"):
    emb = HashEmbeddings(dim=32)
    j = TPUVectorStore(emb, dtype=jnp.int8, capacity=1024, refine=refine)
    t = TorchVectorStore(emb, dtype=torch.int8, capacity=1024, refine=refine, device="cpu")
    texts = _texts(80)
    for store in (j, t):
        for lo, hi in ((0, 1), (1, 6), (6, 80)):
            store.add_texts(texts[lo:hi], ids=[f"d{i}" for i in range(lo, hi)])
        store.delete(["d3", "d17"])
    return j, t, emb, texts


def _ids(results):
    return [[d.id for d, _ in hits] for hits in results]


@pytest.mark.parametrize("refine", ["default", None, "int8"])
def test_store_matches_jax(refine):
    j, t, _, texts = _stores(refine)
    queries = texts[:8] + ["topic 3", "nothing like it"]
    want = j.batch_similarity_search_with_score(queries, k=5)
    got = t.batch_similarity_search_with_score(queries, k=5)
    assert _ids(got) == _ids(want)
    np.testing.assert_allclose([[s for _, s in h] for h in got],
                               [[s for _, s in h] for h in want], rtol=0, atol=ATOL)
    assert [d.id for d in t.as_retriever(search_kwargs={"k": 3}).invoke(texts[9])] == [
        d.id for d in j.as_retriever(search_kwargs={"k": 3}).invoke(texts[9])]
    ji, ti = j.get_vectorstore_info(), t.get_vectorstore_info()
    assert ti["num_documents"] == ji["num_documents"]
    assert {k: ti["index"][k] for k in ("gap_rows", "refine", "active", "hbm_bytes")} == {
        k: ji["index"][k] for k in ("gap_rows", "refine", "active", "hbm_bytes")}


def test_store_warns_when_refine_cannot_apply(caplog):
    with caplog.at_level(logging.WARNING):
        TorchVectorStore(HashEmbeddings(dim=32), dtype=torch.bfloat16, refine="int8",
                         device="cpu")
    assert "has no effect" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        TorchVectorStore(HashEmbeddings(dim=32), dtype=torch.int8, refine="int8", device="cpu")
    assert "has no effect" not in caplog.text


def _same_snapshot_state(a, b):
    """Index arrays and bookkeeping of two stores (either package)."""
    ia, ib = a.index, b.index
    assert (ia.size, ia.n_deleted, ia._gap_rows, ia._tail_scale, ia.refine, ia.capacity) == (
        ib.size, ib.n_deleted, ib._gap_rows, ib._tail_scale, ib.refine, ib.capacity)
    n = ia.size
    names = ["emb", "sqnorm", "valid"] + (["res", "res_scale"] if ia.refine else [])
    for name in names:
        np.testing.assert_array_equal(np.asarray(getattr(ia, name)[:n]),
                                      np.asarray(getattr(ib, name)[:n]), err_msg=name)


@pytest.mark.parametrize("refine", ["default", "int8", None])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_int8_snapshot_crosses_packages(tmp_path, direction, refine):
    j, t, emb, texts = _stores(refine)
    if direction == "jax_to_torch":
        jpers.save_store(j, tmp_path / "snap")
        src, loaded = j, tpers.load_store(tmp_path / "snap", emb, device="cpu")
    else:
        tpers.save_store(t, tmp_path / "snap")
        src, loaded = t, jpers.load_store(tmp_path / "snap", emb)
    _same_snapshot_state(src, loaded)
    assert loaded.index.quantized and len(loaded) == len(src)
    queries = texts[:6]
    got = loaded.batch_similarity_search_with_score(queries, k=5)
    want = src.batch_similarity_search_with_score(queries, k=5)
    assert _ids(got) == _ids(want)
    np.testing.assert_allclose([[s for _, s in h] for h in got],
                               [[s for _, s in h] for h in want], rtol=0, atol=ATOL)
    # further adds after the restore keep filling the tail block
    loaded.add_texts(["a brand new document"], ids=["new"])
    assert loaded.similarity_search("a brand new document", k=1)[0].id == "new"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float_snapshot_crosses_packages(tmp_path, dtype):
    emb = HashEmbeddings(dim=32)
    texts = _texts(40)
    j = TPUVectorStore(emb, dtype=getattr(jnp, dtype))
    j.add_texts(texts, ids=[f"d{i}" for i in range(40)])
    j.delete(["d5"])
    jpers.save_store(j, tmp_path / "a")
    t = tpers.load_store(tmp_path / "a", emb, device="cpu")
    assert t.index.dtype == getattr(torch, dtype) and t.index.n_deleted == 1
    tpers.save_store(t, tmp_path / "b")
    back = jpers.load_store(tmp_path / "b", emb)
    for store in (t, back):
        assert _ids(store.batch_similarity_search_with_score(texts[:5], k=3)) == _ids(
            j.batch_similarity_search_with_score(texts[:5], k=3))


def test_snapshot_refusals(tmp_path):
    j, t, emb, _ = _stores()
    tpers.save_store(t, tmp_path / "snap")
    with pytest.raises(ValueError, match="int8 codes"):
        tpers.load_store(tmp_path / "snap", emb, dtype=torch.float32, device="cpu")
    manifest = json.loads((tmp_path / "snap" / "manifest.json").read_text())
    # blob-docstore snapshots load now (tests/test_torch_ingest.py)
    for key, value, match in (("index_kind", "ivf", "Queue 1 #13"),
                              ("index_kind", "hnsw", "Queue 1 #13")):
        bad = dict(manifest, **{key: value})
        (tmp_path / "snap" / "manifest.json").write_text(json.dumps(bad))
        with pytest.raises(NotImplementedError, match=match):
            tpers.load_store(tmp_path / "snap", emb, device="cpu")
