"""Parity of the port's ops with the JAX package on the CPU: the sub-tile
max producer's plain version against both TPU producers and the l2 grid
kernel (Pallas interpret mode), the select/rescore stages, and the
direct/chunked top-k.

Inputs are numpy arrays made from a seed and handed to both packages."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rag_arc_tpu.ops import topk as jtopk
from rag_arc_tpu.ops import two_level as jtl
from rag_arc_tpu.ops.two_level_stream import (
    subtile_max_stream,
    two_level_topk_certified,
    two_level_topk_certified_i8,
)
from rag_arc_tpu_torch.ops import subtile_max as sm
from rag_arc_tpu_torch.ops import subtile_max_piped as smp
from rag_arc_tpu_torch.ops import topk as ttopk
from rag_arc_tpu_torch.ops import two_level as ttl

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(seed, n=4096, d=64, b=8, dead=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    valid = np.ones(n, bool)
    if dead:
        valid[5] = False
        valid[2048:2080] = False  # whole dead sub-tiles at g = 16 and 32
        valid[rng.integers(0, n, 60)] = False
        x[~valid] = 0.0  # the index layer's invariant
    return q, x, valid


def _jax_grid_submax(q, x, valid, g, tile_n=1024):
    """two_level_topk's pass 1 (_subtile_max_kernel_ip) on its own, as
    two_level_topk launches it, in interpret mode → (N/g, B)."""
    n, d = x.shape
    b = q.shape[0]
    spec = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
    return pl.pallas_call(
        functools.partial(jtl._subtile_max_kernel_ip, g=g),
        grid=(n // tile_n, 1),
        in_specs=[
            spec((b, d), lambda i, j: (j, 0)),
            spec((tile_n, d), lambda i, j: (i, 0)),
            spec((tile_n // g, g), lambda i, j: (i, 0)),
        ],
        out_specs=spec((tile_n // g, b), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((n // g, b), jnp.float32),
        interpret=True,
    )(q, x, valid.astype(jnp.int8).reshape(n // g, g))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("g", [16, 32])
def test_producer_matches_both_tpu_kernels(dtype, g):
    jdt, tdt = DTYPES[dtype]
    q, x, valid = _data(0)
    jq, jx, jv = jnp.asarray(q, jdt), jnp.asarray(x, jdt), jnp.asarray(valid)
    got = sm.subtile_max(
        torch.from_numpy(q).to(tdt), torch.from_numpy(x).to(tdt),
        torch.from_numpy(valid), g,
    ).numpy()
    stream = np.asarray(
        subtile_max_stream(jq, jx, jv, g=g, tile_n=1024, interpret=True, masked=True)
    )
    grid = np.asarray(_jax_grid_submax(jq, jx, jv, g))
    # the port is (B, N/g), the TPU kernels (N/g, B); f32 sums, so the
    # only difference is summation order
    np.testing.assert_allclose(got, stream.T, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, grid.T, rtol=0, atol=1e-5)
    assert (got[:, 2048 // g] == np.float32(sm.NEG)).all()


def test_cpu_wrapper_takes_plain_version_without_counting():
    q, x, valid = _data(1, n=1024)
    before = sm.launches
    out = sm.subtile_max(torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(valid))
    assert sm.launches == before
    np.testing.assert_array_equal(
        out.numpy(),
        sm.subtile_max_plain(
            torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(valid), 16
        ).numpy(),
    )


@pytest.mark.parametrize(
    "bad, match",
    [
        (dict(g=48), "g must be"),
        (dict(n=1000), "multiple of g"),
        (dict(qdtype=torch.bfloat16), "differ"),
    ],
)
def test_wrapper_refuses(bad, match):
    q, x, valid = _data(2, n=bad.get("n", 1024), dead=False)
    tq = torch.from_numpy(q).to(bad.get("qdtype", torch.float32))
    with pytest.raises(ValueError, match=match):
        sm.subtile_max(tq, torch.from_numpy(x), torch.from_numpy(valid), bad.get("g", 16))


# -- the producer switch: piped and scan producers ------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("g", [16, 32])
def test_piped_producer_matches_tpu_piped_kernel(dtype, g):
    # the TPU kernel is maskless: every row live here
    jdt, tdt = DTYPES[dtype]
    q, x, valid = _data(11, dead=False)
    want = np.asarray(subtile_max_stream(jnp.asarray(q, jdt), jnp.asarray(x, jdt),
                                         jnp.asarray(valid), g=g, tile_n=1024,
                                         interpret=True, pipelined=True))
    got = smp.subtile_max_piped(torch.from_numpy(q).to(tdt), torch.from_numpy(x).to(tdt),
                                torch.from_numpy(valid), g).numpy()
    np.testing.assert_allclose(got, want.T, rtol=0, atol=1e-5)


def _i8_data(seed, n=4096, d=64, b=8):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (n, d)).astype(np.int8)
    q = rng.integers(-127, 128, (b, d)).astype(np.int8)
    scale = np.repeat(rng.random(n // 32).astype(np.float32) + 0.1, 32)
    return q, codes, scale


@pytest.mark.parametrize("g", [16, 32])
def test_piped_producer_int8_matches_tpu_piped_kernel(g):
    # the TPU kernel's int8 mode gives raw int32 maxima; the port's block
    # mode gives them times the sub-tile's scale: exactly equal
    q, codes, scale = _i8_data(12)
    raw = np.asarray(subtile_max_stream(jnp.asarray(q), jnp.asarray(codes),
                                        jnp.ones(len(codes), bool), g=g, tile_n=1024,
                                        interpret=True, pipelined=True))
    got = smp.subtile_max_piped(torch.from_numpy(q), torch.from_numpy(codes),
                                torch.ones(len(codes), dtype=torch.bool), g,
                                scale=torch.from_numpy(scale)).numpy()
    np.testing.assert_array_equal(got, raw.T * scale[::g][None, :])


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_scan_producer_matches_jax_scan(dtype):
    if dtype == "int8":
        q, x, scale = _i8_data(13)
        jq, jx = jnp.asarray(q), jnp.asarray(x)
        tq, tx = torch.from_numpy(q), torch.from_numpy(x)
        ones = np.ones(len(x), np.float32)  # scale 1: the raw int32 maxima
        got = ttl.subtile_max_scan(tq, tx, torch.ones(len(x), dtype=torch.bool), 16, 1024,
                                   scale=torch.from_numpy(ones)).numpy()
        want = np.asarray(jtl.subtile_max_scan(jq, jx, g=16, tile_n=1024))
        np.testing.assert_array_equal(got, want.T)
        return
    jdt, tdt = DTYPES[dtype]
    q, x, valid = _data(14, dead=False)
    want = np.asarray(jtl.subtile_max_scan(jnp.asarray(q, jdt), jnp.asarray(x, jdt),
                                           g=16, tile_n=1024))
    got = ttl.subtile_max_scan(torch.from_numpy(q).to(tdt), torch.from_numpy(x).to(tdt),
                               torch.from_numpy(valid), 16, 1024).numpy()
    np.testing.assert_allclose(got, want.T, rtol=0, atol=1e-5)


@pytest.mark.parametrize("producer", ["stream", "stream_piped", "scan"])
def test_two_level_producers_match_jax_certified(producer):
    q, x, valid = _data(15)  # dead rows zeroed: the certified path's rule
    q = q * 2.0
    js, jp, _ = two_level_topk_certified(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), jnp.zeros(len(x)), k=10,
        g=16, tile_n=1024, interpret=True, producer=producer)
    ts, tp = ttl.two_level_topk(torch.from_numpy(q), torch.from_numpy(x),
                                torch.from_numpy(valid), 10, g=16, producer=producer,
                                tile_n=1024)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)


@pytest.mark.parametrize("producer", ["stream", "stream_piped", "scan"])
def test_two_level_i8_producers_match_jax_certified(producer):
    q, x, valid = _data(16)
    codes, scales = ttl.quantize_rows_blocked(x, 32)
    codes[~valid] = 0
    js, jp, _ = two_level_topk_certified_i8(
        jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(valid),
        k=10, g=16, tile_n=1024, interpret=True, producer=producer, block_scales=True)
    ts, tp = ttl.two_level_topk_i8(torch.from_numpy(q), torch.from_numpy(codes),
                                   torch.from_numpy(scales), torch.from_numpy(valid), 10,
                                   g=16, block_scales=True, producer=producer, tile_n=1024)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_two_level_g256_matches_jax():
    # the probe's g = 256, served from g = 128 maxima and a pairwise max
    q, x, valid = _data(17)
    js, jp = jtl.two_level_topk(jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid),
                                jnp.zeros(len(x)), k=10, g=256, tile_n=1024,
                                interpret=True)
    ts, tp = ttl.two_level_topk(torch.from_numpy(q), torch.from_numpy(x),
                                torch.from_numpy(valid), 10, g=256)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    sub = sm.subtile_max_plain(torch.from_numpy(q), torch.from_numpy(x),
                               torch.from_numpy(valid), 128)
    np.testing.assert_array_equal(
        sm.widen_g(sub, 256, 128).numpy(),
        sm.subtile_max_plain(torch.from_numpy(q), torch.from_numpy(x),
                             torch.from_numpy(valid), 256).numpy())


def test_producer_switch_refuses():
    q, x, valid = (torch.from_numpy(a) for a in _data(18, n=1024))
    with pytest.raises(ValueError, match="unknown producer"):
        ttl.two_level_topk(q, x, valid, 4, producer="dma")
    with pytest.raises(ValueError, match="l2"):
        ttl.two_level_topk(q, x, valid, 4, metric="l2", sqnorm=(x * x).sum(1),
                           producer="stream_piped")
    with pytest.raises(ValueError, match="block scales"):
        ttl.two_level_topk_i8(q, x.to(torch.int8), torch.ones(1024), valid, 4,
                              producer="stream_piped")
    before = smp.launches
    smp.subtile_max_piped(q, x, valid, 16)
    assert smp.launches == before  # the CPU takes the plain version


def test_quantize_rows_blocked_tensor_matches_jax():
    # a tensor is quantized where it lies and gives tensors; a read-only
    # array goes through the same body and gives arrays
    x = np.random.default_rng(19).standard_normal((1000, 48)).astype(np.float32)
    jc, js = jtl.quantize_rows_blocked(x, 32)
    tc, ts = ttl.quantize_rows_blocked(torch.from_numpy(x), 32)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(ts.numpy(), js)
    x.setflags(write=False)
    nc, ns = ttl.quantize_rows_blocked(x, 32)
    assert isinstance(nc, np.ndarray)
    np.testing.assert_array_equal(nc, jc)
    np.testing.assert_array_equal(ns, js)


# -- select + rescore -------------------------------------------------------


@pytest.mark.parametrize("c, chunk", [(1000, 512), (4096, 512), (300, 128)])
def test_iterative_argmax_resid_matches(c, chunk):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, c)).astype(np.float32)
    x[:, ::7] = 0.5  # constructed ties, across and inside chunks
    x[2, :] = np.float32(jtl.NEG)  # an exhausted row
    x[3, : c // 2] = np.float32(jtl.NEG)
    k = 40
    ji, jl, jr = jtl.iterative_argmax_resid(jnp.asarray(x), k, chunk=chunk)
    ti, tl, tr = ttl.iterative_argmax_resid(torch.from_numpy(x), k, chunk=chunk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def _dup_corpus(seed, n=2048, d=32):
    """Unit rows with exact duplicates: rows 100..103 copy row 7, row 1500
    copies row 40, so equal scores must break toward the same candidate."""
    q, x, valid = _data(seed, n=n, d=d, b=6, dead=False)
    x[100:104] = x[7]
    x[1500] = x[40]
    q[0] = x[7]
    q[1] = x[40]
    valid[300:340] = False
    x[~valid] = 0.0
    return q, x, valid


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [5, 10])
def test_select_rescore_matches_with_ties(dtype, k):
    jdt, tdt = DTYPES[dtype]
    g = 16
    q, x, valid = _dup_corpus(4)
    jq, jx, jv = jnp.asarray(q, jdt), jnp.asarray(x, jdt), jnp.asarray(valid)
    tq, tx, tv = (
        torch.from_numpy(q).to(tdt), torch.from_numpy(x).to(tdt), torch.from_numpy(valid)
    )
    sub = sm.subtile_max_plain(tq, tx, tv, g)
    js, jp = jtl.select_rescore(
        jq, jx, jv, jnp.zeros(len(x)), jnp.asarray(sub.numpy().T), k, g, "cosine"
    )
    ts, tp = ttl.select_rescore(tq, tx, tv, sub, k, g)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    assert tp[0, 0] == 7 and tp[1, 0] == 40  # tie → lower candidate first


def test_select_rescore_fewer_live_rows_than_k():
    q, x, valid = _data(5, n=1024, d=32, b=3, dead=False)
    valid[:] = False
    valid[[3, 500, 999]] = True
    x[~valid] = 0.0
    tq, tx, tv = torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(valid)
    sub = sm.subtile_max(tq, tx, tv, 16)
    ts, tp = ttl.select_rescore(tq, tx, tv, sub, 8, 16)
    js, jp = jtl.select_rescore(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), jnp.zeros(1024),
        jnp.asarray(sub.numpy().T), 8, 16, "cosine",
    )
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert (tp[:, 3:] == -1).all() and (ts[:, 3:] == np.float32(ttl.NEG)).all()


@pytest.mark.parametrize("metric", ["cosine", "ip"])
def test_two_level_topk_matches_jax(metric):
    q, x, valid = _dup_corpus(6)
    q = q * 3.0  # unnormalized: cosine must normalize, ip must not
    js, jp = jtl.two_level_topk(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), jnp.zeros(len(x)),
        k=10, g=16, tile_n=1024, metric=metric, interpret=True,
    )
    ts, tp = ttl.two_level_topk(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(valid),
        10, g=16, metric=metric,
    )
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)


def _jax_l2_submax(q, x, valid, sqnorm, g, tile_n=1024):
    """two_level_topk's l2 pass 1 (_subtile_max_kernel) on its own, as
    two_level_topk launches it, in interpret mode → (N/g, B)."""
    n, d = x.shape
    b = q.shape[0]
    spec = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
    col = spec((tile_n, 1), lambda i, j: (i, 0))
    return pl.pallas_call(
        functools.partial(jtl._subtile_max_kernel, g=g, metric="l2"),
        grid=(n // tile_n, 1),
        in_specs=[spec((b, d), lambda i, j: (j, 0)), spec((tile_n, d), lambda i, j: (i, 0)),
                  col, col],
        out_specs=spec((tile_n // g, b), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((n // g, b), jnp.float32),
        interpret=True,
    )(q, x, valid.astype(jnp.int8).reshape(n, 1), sqnorm.reshape(n, 1))


def _l2_data(seed):
    q, x, valid = _data(seed)
    rng = np.random.default_rng(seed + 100)
    x = x * rng.uniform(0.5, 2.0, (len(x), 1)).astype(np.float32)  # not unit rows
    q = 1.5 * q
    return q, x, valid, (x * x).sum(1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("g", [16, 32])
def test_l2_producer_matches_tpu_kernel(dtype, g):
    jdt, tdt = DTYPES[dtype]
    q, x, valid, sq = _l2_data(10)
    tq = torch.from_numpy(q).to(tdt)
    got = sm.subtile_max(
        tq, torch.from_numpy(x).to(tdt), torch.from_numpy(valid), g,
        sqnorm=torch.from_numpy(sq),
    ).numpy()
    want = np.asarray(_jax_l2_submax(
        jnp.asarray(q, jdt), jnp.asarray(x, jdt), jnp.asarray(valid), jnp.asarray(sq), g))
    np.testing.assert_allclose(got, want.T, rtol=0, atol=1e-5)
    assert (got[:, 2048 // g] == np.float32(sm.NEG)).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_two_level_l2_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    q, x, valid, sq = _l2_data(11)
    x[100:104] = x[7]  # exact duplicates: the tie order is checked
    q[0] = x[7]
    sq = (x * x).sum(1)
    js, jp = jtl.two_level_topk(
        jnp.asarray(q), jnp.asarray(x, jdt), jnp.asarray(valid), jnp.asarray(sq),
        k=10, g=16, tile_n=1024, metric="l2", interpret=True,
    )
    ts, tp = ttl.two_level_topk(
        torch.from_numpy(q), torch.from_numpy(x).to(tdt), torch.from_numpy(valid),
        10, g=16, metric="l2", sqnorm=torch.from_numpy(sq),
    )
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    assert tp[0, :5].tolist() == [7, 100, 101, 102, 103]


def test_two_level_l2_needs_sqnorm():
    q, x, valid = _data(7, n=1024, dead=False)
    with pytest.raises(ValueError, match="sqnorm"):
        ttl.two_level_topk(
            torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(valid),
            5, metric="l2",
        )


# -- direct and chunked top-k ----------------------------------------------


@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
def test_masked_topk_matches_with_ties(metric):
    q, x, valid = _dup_corpus(8)
    sq = (x * x).sum(1)
    js, jp = jtopk.masked_topk(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), 10, metric, jnp.asarray(sq)
    )
    ts, tp = ttopk.masked_topk(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(valid), 10,
        metric, torch.from_numpy(sq),
    )
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)


@pytest.mark.parametrize("metric", ["cosine", "ip"])
def test_masked_topk_chunked_matches(metric):
    q, x, valid = _dup_corpus(9)
    sq = (x * x).sum(1)
    js, jp = jtopk.masked_topk_chunked(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), jnp.asarray(sq), 10,
        metric, chunk=512,
    )
    ts, tp = ttopk.masked_topk_chunked(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(valid),
        torch.from_numpy(sq), 10, metric, chunk=512,
    )
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)


# -- rope_prep (qk-norm + rope + transpose + GQA repeat) -------------------------


def _rope_inputs(seed, b=4, l=64, nh=8, nkv=4, d=128, dtype="bf16"):
    """q/k/v from a seed, HF left-padded positions (zeros through the pad,
    then 0..n-1), and per-head norm scales."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, nh * d)).astype(np.float32)
    k = rng.standard_normal((b, l, nkv * d)).astype(np.float32)
    v = rng.standard_normal((b, l, nkv * d)).astype(np.float32)
    pos = np.zeros((b, l), np.int32)
    for i in range(b):
        live = int(rng.integers(1, l + 1))
        pos[i, l - live :] = np.arange(live)
    qs = rng.uniform(0.5, 1.5, d).astype(np.float32)
    ks = rng.uniform(0.5, 1.5, d).astype(np.float32)
    if dtype == "bf16":  # both packages start from the same bf16 values
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in (q, k, v))
    return q, k, v, pos, qs, ks


def test_rope_cos_sin_matches_jax():
    from rag_arc_tpu.ops.rope_prep import rope_cos_sin as j_cos_sin
    from rag_arc_tpu_torch.ops.rope_prep import rope_cos_sin

    pos = _rope_inputs(0)[3]
    for theta in (1e4, 1e6):
        jc, js = j_cos_sin(jnp.asarray(pos), theta, 128)
        tc, ts = rope_cos_sin(torch.from_numpy(pos), theta, 128)
        # f32 cos/sin of the same angles: a few f32 ulps
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("nh,nkv", [(8, 4), (4, 4), (8, 2)])
def test_rope_prep_plain_matches_jax(nh, nkv, norm, dtype):
    from rag_arc_tpu.ops.rope_prep import rope_cos_sin as j_cos_sin
    from rag_arc_tpu.ops.rope_prep import rope_prep as j_rope_prep
    from rag_arc_tpu.ops.rope_prep import rope_prep_ref
    from rag_arc_tpu_torch.ops import rope_prep as rp

    jdt, tdt = DTYPES[dtype]
    b, l, d = 4, 64, 128
    q, k, v, pos, qs, ks = _rope_inputs(1, b, l, nh, nkv, d, dtype)
    jcos, jsin = j_cos_sin(jnp.asarray(pos), 1e6, d)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    jqs, jks = (jnp.asarray(qs), jnp.asarray(ks)) if norm else (None, None)
    kernel = j_rope_prep(jq, jk, jv, jcos, jsin, jqs, jks, nh=nh, nkv=nkv, d=d,
                         interpret=True)
    ref = rope_prep_ref(jq.reshape(b, l, nh, d), jk.reshape(b, l, nkv, d),
                        jv.reshape(b, l, nkv, d), jcos, jsin, jqs, jks)
    # the same tables on both sides: the test is of the prep, not of cos/sin
    tcos, tsin = torch.from_numpy(np.array(jcos)), torch.from_numpy(np.array(jsin))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    tqs, tks = (torch.from_numpy(qs), torch.from_numpy(ks)) if norm else (None, None)
    before = rp.launches
    got = rp.rope_prep(tq, tk, tv, tcos, tsin, tqs, tks, nh=nh, nkv=nkv, d=d)
    assert rp.launches == before  # CPU tensors take the plain version
    plain = rp.rope_prep_plain(tq.reshape(b, l, nh, d), tk.reshape(b, l, nkv, d),
                               tv.reshape(b, l, nkv, d), tcos, tsin, tqs, tks)
    # bf16: one bf16 ulp at O(1) (the JAX kernel's own bar against its ref,
    # tests/test_rope_prep.py); f32: summation-order noise
    atol = 1e-2 if dtype == "bf16" else 1e-5
    for want in (kernel, ref):
        for g, p, w in zip(got, plain, want):
            assert g.shape == (b, nh, l, d) and g.dtype == tdt
            torch.testing.assert_close(g, p, atol=0, rtol=0)
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                       rtol=0, atol=atol)
        # V is a copy: exact
        np.testing.assert_array_equal(got[2].float().numpy(), np.asarray(want[2], np.float32))


def test_rope_prep_takes_column_slices():
    """The model passes the q/k/v column slices of its fused qkv output."""
    from rag_arc_tpu_torch.ops.rope_prep import rope_cos_sin, rope_prep

    b, l, nh, nkv, d = 2, 8, 4, 2, 64
    qkv = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (b, l, (nh + 2 * nkv) * d)).astype(np.float32))
    q, k, v = qkv[..., : nh * d], qkv[..., nh * d : (nh + nkv) * d], qkv[..., (nh + nkv) * d :]
    cos, sin = rope_cos_sin(torch.arange(l).repeat(b, 1), 1e4, d)
    got = rope_prep(q, k, v, cos, sin, nh=nh, nkv=nkv, d=d)
    want = rope_prep(q.contiguous(), k.contiguous(), v.contiguous(), cos, sin,
                     nh=nh, nkv=nkv, d=d)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_rope_prep_checks_shapes():
    from rag_arc_tpu_torch.ops.rope_prep import rope_prep

    q, k = torch.zeros(2, 8, 4 * 64), torch.zeros(2, 8, 2 * 64)
    cos = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="expected"):
        rope_prep(q, k, k, cos, cos, nh=4, nkv=2, d=32)
    with pytest.raises(ValueError, match="multiple"):
        rope_prep(q, k, k, cos, cos, nh=4, nkv=3, d=64)
    with pytest.raises(ValueError, match="together"):
        rope_prep(q, k, k, cos, cos, torch.ones(64), nh=4, nkv=2, d=64)


# -- causal segment-masked attention ------------------------------------------------


def _attn_inputs(seed, b=3, h=4, l=40, d=64, dtype="f32"):
    """q/k/v from a seed and left-padded rows: segment ids are the mask as
    int (pad 0, live 1); row 0 is unpadded."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, l, d)).astype(np.float32) for _ in range(3))
    if dtype == "bf16":
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in (q, k, v))
    live = rng.integers(1, l + 1, b)
    live[0] = l
    mask = np.arange(l)[None, :] >= (l - live)[:, None]
    return q, k, v, mask


def _jax_einsum_attention(q, k, v, mask, dtype):
    """The einsum path of rag_arc_tpu/models/qwen3.py: f32 scores, a -1e9
    causal & key-live bias, f32 softmax cast to the compute dtype."""
    l, d = q.shape[2], q.shape[3]
    causal = jnp.tril(jnp.ones((l, l), dtype=bool))[None, None]
    bias = jnp.where(causal & jnp.asarray(mask)[:, None, None, :], 0.0, -1e9)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    scores = jnp.einsum("bhqd,bhkd->bhqk", jq, jk,
                        preferred_element_type=jnp.float32) / np.sqrt(d)
    probs = jax.nn.softmax(scores + bias, axis=-1).astype(dtype)
    return np.asarray(jnp.einsum("bhqk,bhkd->bhqd", probs, jv), np.float32)


@pytest.mark.parametrize("l", [40, 64, 130])
def test_attention_plain_matches_library_reference(l):
    """Every row, pads included, against the library's own reference of the
    kernel the TPU path calls (f32; same segment rule)."""
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        SegmentIds, mha_reference_no_custom_vjp)
    from rag_arc_tpu_torch.ops.flash_attention import attention_plain

    q, k, v, mask = _attn_inputs(4, l=l)
    seg = mask.astype(np.int32)
    scale = 1.0 / np.sqrt(q.shape[-1])
    want = mha_reference_no_custom_vjp(
        *(jnp.asarray(a) for a in (q, k, v)),
        segment_ids=SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg)),
        causal=True, sm_scale=scale,
    )
    got = attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(seg),
                          causal=True, sm_scale=scale)
    # f32 throughout: summation-order noise
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attention_plain_matches_jax_einsum_on_live_rows(dtype):
    from rag_arc_tpu_torch.ops import flash_attention as fa

    jdt, tdt = DTYPES[dtype]
    q, k, v, mask = _attn_inputs(5, dtype=dtype)
    want = _jax_einsum_attention(q, k, v, mask, jdt)
    before = fa.launches
    got = fa.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                             torch.from_numpy(mask.astype(np.int32)))
    assert fa.launches == before  # CPU tensors take the plain version
    assert got.dtype == tdt
    got = got.float().numpy()
    assert np.isfinite(got).all()  # pad rows too: they attend only pads
    live = np.broadcast_to(mask[:, None, :], got.shape[:3])
    # f32: summation order; bf16: the plain version rounds exp(s - max) to
    # bf16 before P·V, the einsum path rounds the normalized probabilities,
    # and both round the output: a few bf16 ulps at |out| < 4
    atol = 1e-5 if dtype == "f32" else 3e-2
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=atol)


def test_attention_pad_rows_attend_only_pads():
    from rag_arc_tpu_torch.ops.flash_attention import attention_plain

    q, k, v, mask = _attn_inputs(6, b=2, l=12)
    mask[1] = np.arange(12) >= 5
    got = attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                          torch.from_numpy(mask.astype(np.int32)), causal=True, sm_scale=0.125)
    # pad row 0 of batch row 1 sees only itself
    torch.testing.assert_close(got[1, :, 0], torch.from_numpy(v[1, :, 0]), atol=1e-6, rtol=0)


def test_flash_attention_checks_shapes():
    from rag_arc_tpu_torch.ops.flash_attention import flash_attention

    q = torch.zeros(2, 4, 8, 64)
    with pytest.raises(ValueError, match="expected"):
        flash_attention(q, q[:, :2], q, torch.ones(2, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="segment_ids"):
        flash_attention(q, q, q, torch.ones(2, 9, dtype=torch.int32))
