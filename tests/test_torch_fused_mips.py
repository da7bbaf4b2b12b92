"""Parity of the port's fused MIPS top-k (its plain version, which CPU
tensors take) with the JAX package's ``fused_mips_topk`` in Pallas
interpret mode, on the same numpy inputs: every metric with and without
``skip_tiles`` and ``packed``, tombstones, fewer live rows than k, one
tile, several k, and integer-valued data on which every f32 dot is exact,
so that ties and the packed quantization compare bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_arc_tpu.ops.fused_mips import fused_mips_topk as jax_fused
from rag_arc_tpu_torch.ops import fused_mips as fm
from rag_arc_tpu_torch.ops import subtile_max as sm


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(seed, n=2048, d=32, b=8, metric="cosine", dead=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    valid = np.ones(n, bool)
    if dead:
        valid[5] = False
        valid[rng.integers(0, n, 40)] = False
    sqnorm = (x * x).sum(1).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    return q, x, valid, sqnorm


def _both(q, x, valid, sqnorm, k, tile_n, metric, skip, packed):
    js, jp = jax_fused(jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid),
                       jnp.asarray(sqnorm), k=k, tile_n=tile_n, metric=metric,
                       interpret=True, skip_tiles=skip, packed=packed)
    ts, tp = fm.fused_mips_topk(torch.from_numpy(q), torch.from_numpy(x),
                                torch.from_numpy(valid), torch.from_numpy(sqnorm), k,
                                tile_n=tile_n, metric=metric, skip_tiles=skip,
                                packed=packed)
    return np.asarray(js), np.asarray(jp), ts.numpy(), tp.numpy()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
def test_matches_jax(metric, skip, packed):
    q, x, valid, sqnorm = _data(0, metric=metric)
    js, jp, ts, tp = _both(q, x, valid, sqnorm, 10, 512, metric, skip, packed)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    assert not np.isin(tp, np.flatnonzero(~valid)).any()


@pytest.mark.parametrize("k", [1, 4, 10])
def test_one_tile_and_k(k):
    q, x, valid, sqnorm = _data(1, n=1024)
    for skip, packed in ((False, False), (True, True)):
        js, jp, ts, tp = _both(q, x, valid, sqnorm, k, 1024, "cosine", skip, packed)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)


@pytest.mark.parametrize("packed", [False, True])
def test_fewer_live_rows_than_k(packed):
    q, x, valid, sqnorm = _data(2, n=1024)
    valid[:] = False
    valid[[3, 700, 1000]] = True
    for skip in (False, True):
        js, jp, ts, tp = _both(q, x, valid, sqnorm, 10, 256, "ip", skip, packed)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tp[:, :3], jp[:, :3])
        assert (tp[:, 3:] == -1).all() and (ts[:, 3:] == fm.NEG).all()
        assert set(tp[0, :3].tolist()) == {3, 700, 1000}
        # the reference's merge masks a picked score to NEG but keeps its
        # position, so once live rows span two tiles its empty slots repeat
        # a live position; the port returns -1 there
        assert (jp[:, 3:] != -1).any()
    # in one tile the running list's empty slots come first: -1 on both
    valid[:] = False
    valid[[3, 200]] = True
    js, jp, ts, tp = _both(q, x, valid, sqnorm, 10, 1024, "ip", True, packed)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("packed,skip", [(False, False), (False, True), (True, True),
                                         (True, False)])
def test_integer_data_bit_exact(packed, skip):
    # integer-valued ip data: every f32 dot is exact in any order, so many
    # scores tie and the tie order and packed quantization decide
    rng = np.random.default_rng(3)
    n, d, b = 2048, 16, 6
    x = rng.integers(-2, 3, (n, d)).astype(np.float32)
    q = rng.integers(-2, 3, (b, d)).astype(np.float32)
    valid = rng.random(n) > 0.05
    sqnorm = (x * x).sum(1).astype(np.float32)
    for metric in ("ip", "l2"):
        js, jp, ts, tp = _both(q, x, valid, sqnorm, 10, 256, metric, skip, packed)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(ts.view(np.int32), js.view(np.int32))


def test_packed_order_and_quantization():
    # the packed order is (quantized score desc, tile asc, in-tile column
    # desc); equal scores in one tile come back highest column first
    x = np.zeros((512, 4), np.float32)
    x[[10, 20, 300, 400], 0] = 1.0
    valid = np.ones(512, bool)
    q = np.array([[1.0, 0, 0, 0]], np.float32)
    sq = np.zeros(512, np.float32)
    _, jp, ts, tp = _both(q, x, valid, sq, 4, 256, "ip", True, True)
    np.testing.assert_array_equal(tp, jp)
    assert tp[0].tolist() == [20, 10, 400, 300]
    low = (1 << fm.packed_bits(256, True)) - 1
    assert (ts.view(np.int32) & low == 0).all()  # positive keys lose their low bits


def test_checks():
    q, x, valid, sqnorm = (torch.from_numpy(a) for a in _data(4, n=1000))
    with pytest.raises(ValueError, match="multiple"):
        fm.fused_mips_topk(q, x, valid, sqnorm, 4, tile_n=512)
    q, x, valid, sqnorm = (torch.from_numpy(a) for a in _data(4, n=1024))
    with pytest.raises(ValueError, match="k must be"):
        fm.fused_mips_topk(q, x, valid, sqnorm, fm.MAX_K + 1, tile_n=512)
    with pytest.raises(ValueError, match="metric"):
        fm.fused_mips_topk(q, x, valid, sqnorm, 4, tile_n=512, metric="dot")
    # any batch: the TPU's B % q_block rule is not ported
    s, p = fm.fused_mips_topk(q[:3], x, valid, sqnorm, 4, tile_n=512, q_block=256)
    assert s.shape == (3, 4) and p.dtype == torch.int64


def test_cpu_wrapper_does_not_count():
    before = fm.launches
    q, x, valid, sqnorm = (torch.from_numpy(a) for a in _data(5, n=1024))
    fm.fused_mips_topk(q, x, valid, sqnorm, 4, tile_n=512)
    assert fm.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [1, 10, 64, 65, 100, 128])
def test_schedule_covers_every_tile_once_and_fits(dtype, k):
    # the kernel's grid at several card sizes: every tile in exactly one
    # split, no split empty, and the block's shared memory within 227 KB
    for sms in (132, 114, 8):
        for n in (2_002_944, 262_144, 1000, 64):
            for b in (1, 7, 64, 65, 256, 257, 512):
                plan = fm.schedule(n, b, k, sms, dtype)
                n_tiles = -(-n // plan.rows)
                assert plan.splits * plan.per >= n_tiles
                assert (plan.splits - 1) * plan.per < n_tiles
                assert plan.smem <= fm.SMEM_LIMIT
                assert plan.qb in (64, 128) and plan.rows in (64, 128)
                if dtype == torch.bfloat16:
                    # the grid fills the card once where the batch allows it
                    assert plan.splits * -(-b // plan.qb) <= max(sms, -(-b // plan.qb))
    # large k takes the smaller query block: its lists would not fit
    big = fm.schedule(2_002_944, 512, k, 132, torch.bfloat16)
    assert big.qb == (128 if k <= 64 else 64)


@pytest.mark.parametrize("packed", [False, True])
def test_plain_at_tile_2048_and_k128_matches_jax(packed):
    # the probe's tile at the largest k: more slots than one tile's live
    # rows can fill on the first tile of several
    q, x, valid, sqnorm = _data(6, n=4096, d=16, b=4)
    js, jp, ts, tp = _both(q, x, valid, sqnorm, fm.MAX_K, 2048, "cosine", True, packed)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_tma_operands_route_keeps_the_result(dtype, metric):
    # the kernel wrapper's copy (d = 100 padded to 16 bytes, a view off a
    # 16-byte boundary) leaves the function unchanged: integer data, so the
    # padded zero columns change no dot in any summation order
    rng = np.random.default_rng(7)
    n, d, b = 2048, 100, 5
    x = torch.from_numpy(rng.integers(-2, 3, (n, d)).astype(np.float32)).to(dtype)
    q = torch.from_numpy(rng.integers(-2, 3, (b, d)).astype(np.float32)).to(dtype)
    valid = torch.from_numpy(rng.random(n) > 0.05)
    sq = (x.float() * x.float()).sum(1)
    xv = torch.cat([x.new_zeros(3), x.flatten()])[3:].view(x.shape)
    qv = torch.cat([q.new_zeros(3), q.flatten()])[3:].view(q.shape)
    qp, xp = sm.tma_operands(qv, xv)
    assert xp.shape[1] * xp.element_size() % 16 == 0 and xp.data_ptr() % 16 == 0
    for skip, packed in ((False, False), (True, True)):
        want = fm.fused_mips_topk_plain(q, x, valid, sq, 10, 1024, metric, skip, packed)
        got = fm.fused_mips_topk_plain(qp, xp, valid, sq, 10, 1024, metric, skip, packed)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0])
