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
from rag_arc_tpu.ops.two_level_stream import subtile_max_stream
from rag_arc_tpu_torch.ops import subtile_max as sm
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
