"""Card-only tests of the port's CUDA kernels (sub-tile max bf16/f32 with
its l2 mode, int8, the sub-tile select, rope_prep, flash attention, the
pipelined producer, the fused top-k and the corpus stream): each kernel
against its plain PyTorch version at small shapes (int8 bit for bit; the
select's live picks, flags and residuals exactly), offset views,
padded d, ragged lengths and query blocks, g up to 256, dead sub-tiles,
KV heads shared by 1-8 query heads, ``out=`` views, the launch counts,
the wrappers' refusals, and small Qwen3 forwards through both attention
kernels (one launch each a layer, no plain version); an HTTP ``/batch``
served at B=300 over a two-level-sized store (the producer and the
select launch once each) and a blob-backed store's snapshot round trip
on the card. They skip where no
CUDA card is present (a CUDA kernel has no CPU mode); on a machine with a
card run

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q

(``--noconftest``: the suite's conftest imports JAX, which a card-only
machine need not have; this file imports only torch and numpy).
"""

import dataclasses

import numpy as np
import pytest
import torch

from rag_arc_tpu_torch.index.flat import DeviceFlatIndex
from rag_arc_tpu_torch.ops import corpus_stream as cst
from rag_arc_tpu_torch.ops import fused_mips as fm
from rag_arc_tpu_torch.ops import subtile_max as sm
from rag_arc_tpu_torch.ops import subtile_max_i8 as smi8
from rag_arc_tpu_torch.ops import subtile_max_piped as smp
from rag_arc_tpu_torch.ops import subtile_select as ss
from rag_arc_tpu_torch.ops.two_level import quantize_rows_blocked, two_level_topk
from rag_arc_tpu_torch.ops.topk import masked_topk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, d, b, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    valid = rng.random(n) > 0.03
    x[~valid] = 0.0
    return (
        torch.from_numpy(q).to(device, dtype),
        torch.from_numpy(x).to(device, dtype),
        torch.from_numpy(valid).to(device),
    )


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 7, 17, 130])
@pytest.mark.parametrize("n,d", [(4096, 64), (1056, 100)])  # ragged rows and d
@pytest.mark.parametrize("g", [16, 32])
def test_kernel_matches_plain(cuda, dtype, b, n, d, g):
    q, x, valid = _inputs(n, d, b, dtype, cuda)
    got = sm.subtile_max(q, x, valid, g)
    torch.cuda.synchronize()
    want = sm.subtile_max_plain(q, x, valid, g)
    # bf16 products are exact in f32; only the summation order differs
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("offset", [1, 3, 8])
def test_kernel_on_offset_views(cuda, offset):
    # contiguous views whose data starts `offset` elements into their
    # storage: off a 16-byte boundary unless offset % 8 == 0
    q, x, valid = _inputs(1024, 64, 5, torch.bfloat16, cuda)
    qv = torch.cat([q.new_zeros(offset), q.flatten()])[offset:].view(q.shape)
    xv = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(x.shape)
    assert qv.is_contiguous() and xv.is_contiguous()
    assert qv.storage_offset() == xv.storage_offset() == offset
    got = sm.subtile_max(qv, xv, valid, 16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, sm.subtile_max_plain(q, x, valid, 16), atol=1e-4, rtol=0)


def test_all_dead_subtile_is_neg(cuda):
    q, x, valid = _inputs(1024, 64, 4, torch.bfloat16, cuda)
    valid[32:48] = False
    got = sm.subtile_max(q, x, valid, 16)
    assert (got[:, 2] == sm.NEG).all()


@pytest.mark.parametrize("b", [7, 130, 300])
@pytest.mark.parametrize("g", [64, 128, 256])
@pytest.mark.parametrize("l2", [False, True])
def test_kernel_wide_g_and_dead_subtiles(cuda, b, g, l2):
    """The wgmma kernel at g up to 256 (served from g = 128 maxima), a
    ragged 256-query block, and whole dead sub-tiles, in both modes."""
    q, x, valid = _inputs(4096, 96, b, torch.bfloat16, cuda, seed=4)
    valid[512:1024] = False
    x[~valid] = 0
    sq = (x.float() * x.float()).sum(1) if l2 else None
    got = sm.subtile_max(q, x, valid, g, sqnorm=sq)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, sm.subtile_max_plain(q, x, valid, g, sqnorm=sq),
                               atol=1e-4, rtol=0)
    assert (got[:, 512 // g : 1024 // g] == sm.NEG).all()


@pytest.mark.parametrize("d", [100, 36])
@pytest.mark.parametrize("offset", [0, 3])
def test_l2_kernel_on_padded_and_offset_operands(cuda, d, offset):
    """The wrapper's copies (d % 8 != 0, a base off 16 bytes) feed the l2
    mode too."""
    q, x, valid = _inputs(2048, d, 33, torch.bfloat16, cuda, seed=5)
    sq = (x.float() * x.float()).sum(1)
    qv = torch.cat([q.new_zeros(offset), q.flatten()])[offset:].view(q.shape)
    xv = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(x.shape)
    got = sm.subtile_max(qv, xv, valid, 16, sqnorm=sq)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, sm.subtile_max_plain(q, x, valid, 16, sqnorm=sq),
                               atol=1e-4, rtol=0)


def test_launch_count(cuda):
    q, x, valid = _inputs(1024, 64, 4, torch.bfloat16, cuda)
    before = sm.launches
    sm.subtile_max(q, x, valid, 16)
    sm.subtile_max_plain(q, x, valid, 16)
    assert sm.launches == before + 1


def test_wrapper_refuses(cuda):
    q, x, valid = _inputs(1024, 64, 4, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sm.subtile_max(q.T.contiguous().T, x, valid, 16)
    with pytest.raises(ValueError, match="differ"):
        sm.subtile_max(q.float(), x, valid, 16)
    with pytest.raises(ValueError, match="g must be"):
        sm.subtile_max(q, x, valid, 48)
    with pytest.raises(ValueError, match="f32 or bf16"):
        sm.subtile_max(q.half(), x.half(), valid, 16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_two_level_matches_direct_on_card(cuda, dtype):
    q, x, valid = _inputs(8192, 64, 33, dtype, cuda, seed=1)
    s1, p1 = two_level_topk(q.float(), x, valid, 10)
    s2, p2 = masked_topk(q.float(), x, valid, 10)
    torch.testing.assert_close(p1, p2, atol=0, rtol=0)
    torch.testing.assert_close(s1, s2, atol=1e-5, rtol=0)


# -- l2 mode ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 17, 130])
@pytest.mark.parametrize("n,d", [(4096, 64), (1056, 100)])
def test_l2_kernel_matches_plain(cuda, dtype, b, n, d):
    q, x, valid = _inputs(n, d, b, dtype, cuda)
    sq = (x.float() * x.float()).sum(1)
    before = sm.launches_l2
    got = sm.subtile_max(q, x, valid, 16, sqnorm=sq)
    torch.cuda.synchronize()
    assert sm.launches_l2 == before + 1
    torch.testing.assert_close(got, sm.subtile_max_plain(q, x, valid, 16, sqnorm=sq),
                               atol=1e-4, rtol=0)


def test_l2_two_level_matches_direct_on_card(cuda):
    q, x, valid = _inputs(8192, 64, 33, torch.bfloat16, cuda, seed=2)
    sq = (x.float() * x.float()).sum(1)
    s1, p1 = two_level_topk(q.float(), x, valid, 10, metric="l2", sqnorm=sq)
    s2, p2 = masked_topk(q.float(), x, valid, 10, "l2", sq)
    torch.testing.assert_close(p1, p2, atol=0, rtol=0)
    torch.testing.assert_close(s1, s2, atol=1e-5, rtol=0)


# -- int8 ---------------------------------------------------------------------------


def _i8_inputs(n, d, b, device, block=True, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (n, d), dtype=np.int8)
    if block:
        scale = np.repeat(rng.uniform(1e-3, 1e-2, n // 32), 32).astype(np.float32)
    else:
        scale = rng.uniform(1e-3, 1e-2, n).astype(np.float32)
    valid = rng.random(n) > 0.03
    codes[~valid] = 0
    q = rng.integers(-127, 128, (b, d), dtype=np.int8)
    return tuple(torch.from_numpy(a).to(device) for a in (q, codes, scale, valid))


@pytest.mark.parametrize("block", [True, False])
@pytest.mark.parametrize("b", [1, 7, 17, 130])
@pytest.mark.parametrize("n,d", [(4096, 64), (1056, 100), (2048, 1040)])
@pytest.mark.parametrize("g", [16, 32])
def test_i8_kernel_equals_plain(cuda, block, b, n, d, g):
    q, codes, scale, valid = _i8_inputs(n, d, b, cuda, block)
    got = smi8.subtile_max_i8(q, codes, scale, valid, g, block_scales=block)
    torch.cuda.synchronize()
    want = smi8.subtile_max_i8_plain(q, codes, scale, valid, g, block_scales=block)
    torch.testing.assert_close(got, want, atol=0, rtol=0)  # every step is exact


@pytest.mark.parametrize("offset", [1, 5, 16])
def test_i8_kernel_on_offset_views(cuda, offset):
    q, codes, scale, valid = _i8_inputs(1024, 64, 5, cuda)
    qv = torch.cat([q.new_zeros(offset), q.flatten()])[offset:].view(q.shape)
    cv = torch.cat([codes.new_zeros(offset), codes.flatten()])[offset:].view(codes.shape)
    got = smi8.subtile_max_i8(qv, cv, scale, valid, 16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, smi8.subtile_max_i8_plain(q, codes, scale, valid, 16),
                               atol=0, rtol=0)


@pytest.mark.parametrize("block", [True, False])
@pytest.mark.parametrize("b", [1, 7, 128, 130, 512])
@pytest.mark.parametrize("g", [16, 32, 64, 128, 256])
def test_i8_kernel_wide_g_and_dead_subtiles(cuda, block, b, g):
    """The s8 wgmma kernel bit for bit: 128- and 256-query blocks, ragged
    ones (B = 130), g up to 256 (served from g = 128 maxima), N off a
    128-row tile where g allows it, and whole dead sub-tiles."""
    n = 4096 + (32 if g <= 32 else 256)
    q, codes, scale, valid = _i8_inputs(n, 96, b, cuda, block, seed=6)
    if block:  # block mode asserts one scale per g-row sub-tile
        scale = scale[::g].repeat_interleave(g)
    valid[512:1024] = False
    codes[~valid] = 0
    before = smi8.launches
    got = smi8.subtile_max_i8(q, codes, scale, valid, g, block_scales=block)
    torch.cuda.synchronize()
    assert smi8.launches == before + 1
    want = smi8.subtile_max_i8_plain(q, codes, scale, valid, g, block_scales=block)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert (got[:, 512 // g : 1024 // g] == smi8.NEG).all()


@pytest.mark.parametrize("block", [True, False])
@pytest.mark.parametrize("offset", [0, 3])
def test_i8_kernel_on_padded_and_offset_operands(cuda, block, offset):
    """d = 100 (the wrapper's zero-padding copy to 112) and a base off 16
    bytes (its aligning copy), in both modes, bit for bit."""
    q, codes, scale, valid = _i8_inputs(2048, 100, 130, cuda, block, seed=7)
    qv = torch.cat([q.new_zeros(offset), q.flatten()])[offset:].view(q.shape)
    cv = torch.cat([codes.new_zeros(offset), codes.flatten()])[offset:].view(codes.shape)
    got = smi8.subtile_max_i8(qv, cv, scale, valid, 16, block_scales=block)
    torch.cuda.synchronize()
    want = smi8.subtile_max_i8_plain(q, codes, scale, valid, 16, block_scales=block)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_i8_all_dead_subtile_and_launch_count(cuda):
    q, codes, scale, valid = _i8_inputs(1024, 64, 4, cuda)
    valid[32:48] = False
    before = smi8.launches
    got = smi8.subtile_max_i8(q, codes, scale, valid, 16)
    smi8.subtile_max_i8_plain(q, codes, scale, valid, 16)
    assert smi8.launches == before + 1
    assert (got[:, 2] == smi8.NEG).all()


def test_i8_wrapper_refuses(cuda):
    q, codes, scale, valid = _i8_inputs(1024, 64, 4, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        smi8.subtile_max_i8(q.T.contiguous().T, codes, scale, valid, 16)
    with pytest.raises(ValueError, match="1040"):
        big = torch.zeros((1024, 1056), dtype=torch.int8, device=cuda)
        smi8.subtile_max_i8(torch.zeros((4, 1056), dtype=torch.int8, device=cuda),
                            big, scale, valid, 16)


@pytest.mark.parametrize("metric", ["cosine", "ip"])
def test_i8_index_on_card_matches_cpu(cuda, metric):
    # every int8 search on the card takes the kernel path; its ids equal
    # the CPU index's direct path (exact under the quantized metric)
    rng = np.random.default_rng(3)
    v = rng.standard_normal((5000, 64)).astype(np.float32)
    q = v[:9] + 0.05 * rng.standard_normal((9, 64)).astype(np.float32)
    idx = {dev: DeviceFlatIndex(dim=64, metric=metric, capacity=8192, dtype=torch.int8,
                                device=dev) for dev in ("cpu", cuda)}
    for index in idx.values():
        index.add(v)
        index.mark_deleted(np.arange(50, 90))
    before = smi8.launches
    s_gpu, p_gpu = idx[cuda].search(q, 10)
    assert smi8.launches == before + 1
    s_cpu, p_cpu = idx["cpu"].search(q, 10)
    np.testing.assert_array_equal(p_gpu, p_cpu)
    np.testing.assert_allclose(s_gpu, s_cpu, rtol=1e-5, atol=1e-5)


def test_i8_blocked_codes_on_card(cuda):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2048, 64)).astype(np.float32)
    codes, scale = quantize_rows_blocked(x, 32)
    q = torch.from_numpy(rng.integers(-127, 128, (33, 64), dtype=np.int8)).to(cuda)
    args = (q, torch.from_numpy(codes).to(cuda), torch.from_numpy(scale).to(cuda),
            torch.ones(2048, dtype=torch.bool, device=cuda), 16)
    torch.testing.assert_close(smi8.subtile_max_i8(*args), smi8.subtile_max_i8_plain(*args),
                               atol=0, rtol=0)


# -- sub-tile select ------------------------------------------------------------------


def _select_slab(b, c, k, device, seed=0):
    """(B, C) f32 rows of sub-tile maxima, one pattern a row (by row index
    mod 6): random with ~3% dead (NEG) entries; more ties at the k-th
    value than slots; -0.0 beside +0.0 around the k-th; all NEG; half
    NEG; three live entries."""
    rng = np.random.default_rng(seed)
    neg = np.float32(ss.NEG)
    x = rng.uniform(-0.2, 0.9, (b, c)).astype(np.float32)
    for r in range(b):
        kind = r % 6
        if kind == 0:
            x[r, rng.random(c) < 0.03] = neg
        elif kind == 1:
            x[r] = rng.uniform(-0.5, 0.4, c)
            x[r, rng.choice(c, min(c, 3 * k + 2), replace=False)] = 0.5
            x[r, rng.choice(c, k // 2, replace=False)] = 0.75
        elif kind == 2:
            x[r] = rng.uniform(-1.0, -0.1, c)
            zeros = rng.choice(c, min(c, 2 * k + 4), replace=False)
            x[r, zeros] = np.where(np.arange(len(zeros)) % 2, np.float32(-0.0), np.float32(0.0))
            x[r, rng.choice(c, k // 3, replace=False)] = 0.25
        elif kind == 3:
            x[r] = neg
        elif kind == 4:
            x[r, : c // 2] = neg
        else:
            x[r] = neg
            x[r, rng.choice(c, min(c, 3), replace=False)] = rng.uniform(0.1, 0.9, min(c, 3))
    return torch.from_numpy(x).to(device)


def _select_equal(got, want, c):
    """Live picks, flags and residuals equal; every pick in range and the
    picks of a row distinct (the kernel never re-picks)."""
    (gi, gl, gr), (wi, wl, wr) = got, want
    torch.testing.assert_close(gl, wl, atol=0, rtol=0)
    torch.testing.assert_close(torch.where(wl, gi, -1), torch.where(wl, wi, -1), atol=0, rtol=0)
    torch.testing.assert_close(gr, wr, atol=0, rtol=0)
    assert int(gi.min()) >= 0 and int(gi.max()) < c
    srt = torch.sort(gi, dim=1).values
    assert bool((srt[:, 1:] != srt[:, :-1]).all())


@pytest.mark.parametrize("b", [1, 7, 512])
@pytest.mark.parametrize("c,k", [(1000, 1), (1000, 10), (1000, 20), (1000, 100), (1000, 1000),
                                 (125_000, 1), (125_000, 10), (125_000, 20), (125_000, 100)])
def test_select_kernel_equals_plain(cuda, b, c, k):
    x = _select_slab(b, c, k, cuda, seed=c + k)
    before = ss.launches
    got = ss.iterative_argmax_resid(x, k)
    torch.cuda.synchronize()
    assert ss.launches == before + 1
    _select_equal(got, ss.iterative_argmax_resid_plain(x, k), c)
    assert ss.launches == before + 1


@pytest.mark.parametrize("c,k", [(9000, 4095), (9000, 4096), (9000, 9000), (125_000, 125_000)])
def test_select_kernel_large_k(cuda, c, k):
    """k past the shared-memory buffer: each row sorted whole in a global
    scratch. Held against a stable descending sort (the plain tournament
    would take k steps), -0.0 keyed as +0.0 by adding 0.0."""
    x = _select_slab(7, c, k, cuda, seed=k)
    gi, gl, gr = ss.iterative_argmax_resid(x, k)
    order = torch.sort(x + 0.0, dim=1, descending=True, stable=True)
    wl = order.values[:, :k] > ss.NEG * 0.5
    want_r = (torch.clamp(order.values[:, k], min=ss.NEG) if k < c
              else torch.full((7,), ss.NEG, device=cuda))
    _select_equal((gi, gl, gr), (order.indices[:, :k], wl, want_r), c)


def test_select_kernel_on_a_real_slab_and_refusals(cuda):
    """The select on a producer's output, then the wrapper's refusals."""
    q, x, valid = _inputs(32768, 64, 33, torch.bfloat16, cuda, seed=8)
    sub = sm.subtile_max(q, x, valid, 16)
    for k in (10, 20, 100):
        _select_equal(ss.iterative_argmax_resid(sub, k), ss.iterative_argmax_resid_plain(sub, k),
                      sub.shape[1])
    with pytest.raises(ValueError, match="contiguous"):
        ss.iterative_argmax_resid(sub.T.contiguous().T, 10)
    with pytest.raises(ValueError, match="float32"):
        ss.iterative_argmax_resid(sub.half(), 10)
    with pytest.raises(ValueError, match="k must"):
        ss.iterative_argmax_resid(sub, 0)
    with pytest.raises(ValueError, match="k must"):
        ss.iterative_argmax_resid(sub, sub.shape[1] + 1)


@pytest.mark.parametrize("k", [10, 50])
def test_two_level_launches_select_once(cuda, k):
    q, x, valid = _inputs(8192, 64, 33, torch.bfloat16, cuda, seed=9)
    before = ss.launches
    s1, p1 = two_level_topk(q.float(), x, valid, k)
    assert ss.launches == before + 1
    s2, p2 = masked_topk(q.float(), x, valid, k)
    torch.testing.assert_close(p1, p2, atol=0, rtol=0)
    torch.testing.assert_close(s1, s2, atol=1e-5, rtol=0)


# -- rope_prep --------------------------------------------------------------------


def _rope_case(b, l, nh, nkv, d, dtype, device, norm=True, seed=0):
    from rag_arc_tpu_torch.ops.rope_prep import rope_cos_sin

    gen = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, l, nh * d, generator=gen).to(device, dtype)
    k = torch.randn(b, l, nkv * d, generator=gen).to(device, dtype)
    v = torch.randn(b, l, nkv * d, generator=gen).to(device, dtype)
    live = torch.randint(1, l + 1, (b,), generator=gen)
    mask = torch.arange(l)[None, :] >= (l - live)[:, None]
    pos = torch.clamp(torch.cumsum(mask.long(), 1) - 1, min=0).to(device)
    cos, sin = rope_cos_sin(pos, 1e6, d)
    qs = ks = None
    if norm:
        qs = (torch.rand(d, generator=gen) + 0.5).to(device)
        ks = (torch.rand(d, generator=gen) + 0.5).to(device)
    return q, k, v, cos, sin, qs, ks


def _rope_check(got, q, k, v, cos, sin, qs, ks, nh, nkv, d):
    from rag_arc_tpu_torch.ops import rope_prep as rp

    b, l, _ = q.shape
    want = rp.rope_prep_plain(q.reshape(b, l, nh, d), k.reshape(b, l, nkv, d),
                              v.reshape(b, l, nkv, d), cos, sin, qs, ks)
    # bf16: one bf16 ulp (the f32 arithmetic is the same up to FMA
    # contraction; only a rounding boundary can flip); f32: FMA contraction
    atol, rtol = (1e-2, 8e-3) if q.dtype == torch.bfloat16 else (1e-5, 1e-6)
    for g, w in zip(got, want):
        assert g.shape == (b, nh, l, d) and g.dtype == q.dtype
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(got[2], want[2], atol=0, rtol=0)  # V: a copy


@pytest.mark.parametrize("b,l,nh,nkv,d,dtype,norm", [
    (4, 128, 16, 8, 128, torch.bfloat16, True),
    (3, 77, 16, 8, 128, torch.bfloat16, True),     # ragged L
    (2, 64, 8, 8, 128, torch.bfloat16, True),      # nh == nkv
    (2, 64, 8, 2, 128, torch.bfloat16, False),     # no norm, group 4
    (2, 50, 8, 4, 64, torch.bfloat16, True),       # D = 64
    (2, 33, 8, 4, 128, torch.float32, True),
    (2, 33, 4, 2, 64, torch.float32, False),
])
def test_rope_prep_kernel_matches_plain(cuda, b, l, nh, nkv, d, dtype, norm):
    from rag_arc_tpu_torch.ops import rope_prep as rp

    case = _rope_case(b, l, nh, nkv, d, dtype, cuda, norm)
    before = rp.launches
    got = rp.rope_prep(*case, nh=nh, nkv=nkv, d=d)
    torch.cuda.synchronize()
    assert rp.launches == before + 1
    _rope_check(got, *case, nh, nkv, d)


@pytest.mark.parametrize("b,l,nh,nkv,d,dtype", [
    (4, 128, 16, 8, 128, torch.bfloat16),
    (3, 77, 16, 8, 128, torch.bfloat16),     # ragged L
    (2, 50, 8, 2, 64, torch.bfloat16),       # group 4, D = 64
    (2, 64, 8, 8, 128, torch.bfloat16),      # nh == nkv
    (2, 33, 8, 4, 128, torch.float32),
])
def test_rope_prep_kernel_without_repeat(cuda, b, l, nh, nkv, d, dtype):
    """``repeat_kv=False``: K and V with their NKV heads, each written
    once, against the plain version."""
    from rag_arc_tpu_torch.ops import rope_prep as rp

    q, k, v, cos, sin, qs, ks = _rope_case(b, l, nh, nkv, d, dtype, cuda)
    before = rp.launches
    got = rp.rope_prep(q, k, v, cos, sin, qs, ks, nh=nh, nkv=nkv, d=d, repeat_kv=False)
    torch.cuda.synchronize()
    assert rp.launches == before + 1
    want = rp.rope_prep_plain(q.reshape(b, l, nh, d), k.reshape(b, l, nkv, d),
                              v.reshape(b, l, nkv, d), cos, sin, qs, ks, repeat_kv=False)
    atol, rtol = (1e-2, 8e-3) if dtype == torch.bfloat16 else (1e-5, 1e-6)
    assert got[0].shape == (b, nh, l, d) and got[1].shape == got[2].shape == (b, nkv, l, d)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(got[2], want[2], atol=0, rtol=0)  # V: a copy


@pytest.mark.parametrize("offset", [0, 1, 3])
def test_rope_prep_kernel_on_qkv_slices_and_offset_views(cuda, offset):
    """Column slices of a fused qkv output (rows strided, no copy), and
    views starting off a vector boundary."""
    from rag_arc_tpu_torch.ops import rope_prep as rp

    b, l, nh, nkv, d = 2, 40, 8, 4, 128
    _, _, _, cos, sin, qs, ks = _rope_case(b, l, nh, nkv, d, torch.bfloat16, cuda)
    width = (nh + 2 * nkv) * d
    flat = torch.randn(b * l * width + offset, device=cuda).to(torch.bfloat16)
    qkv = flat[offset:].view(b, l, width)
    q, k, v = qkv[..., : nh * d], qkv[..., nh * d : (nh + nkv) * d], qkv[..., (nh + nkv) * d :]
    got = rp.rope_prep(q, k, v, cos, sin, qs, ks, nh=nh, nkv=nkv, d=d)
    torch.cuda.synchronize()
    _rope_check(got, q, k, v, cos, sin, qs, ks, nh, nkv, d)


def test_rope_prep_wrapper_refuses(cuda):
    from rag_arc_tpu_torch.ops import rope_prep as rp

    q, k, v, cos, sin, qs, ks = _rope_case(2, 16, 4, 2, 128, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rp.rope_prep(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, cos, sin,
                     nh=4, nkv=2, d=128)
    with pytest.raises(ValueError, match="head dim"):
        q32, k32, cos32, sin32 = (torch.zeros(2, 16, n, device=cuda, dtype=t) for n, t in
                                  ((4 * 32, torch.bfloat16), (2 * 32, torch.bfloat16),
                                   (32, torch.float32), (32, torch.float32)))
        rp.rope_prep(q32, k32, k32, cos32, sin32, nh=4, nkv=2, d=32)
    with pytest.raises(ValueError, match="all f32 or all bf16"):
        rp.rope_prep(q.half(), k.half(), v.half(), cos, sin, nh=4, nkv=2, d=128)
    with pytest.raises(ValueError, match="float32"):
        rp.rope_prep(q, k, v, cos.bfloat16(), sin, nh=4, nkv=2, d=128)


# -- flash attention ------------------------------------------------------------------


def _attn_case(b, h, l, d, dtype, device, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(b, h, l, d, generator=gen).to(device, dtype) for _ in range(3))
    live = torch.randint(1, l + 1, (b,), generator=gen)
    live[0] = l
    seg = (torch.arange(l)[None, :] >= (l - live)[:, None]).to(device, torch.int32)
    return q, k, v, seg


def _gqa_case(b, h, hkv, l, d, dtype, device, seed=0):
    q, _, _, seg = _attn_case(b, h, l, d, dtype, device, seed)
    gen = torch.Generator(device="cpu").manual_seed(seed + 100)
    k, v = (torch.randn(b, hkv, l, d, generator=gen).to(device, dtype) for _ in range(2))
    return q, k, v, seg


def _attn_check(got, q, k, v, seg, causal=True):
    from rag_arc_tpu_torch.ops.flash_attention import attention_plain

    want = attention_plain(q, k, v, seg, causal=causal, sm_scale=q.shape[-1] ** -0.5)
    assert got.shape == q.shape and got.dtype == q.dtype
    assert torch.isfinite(got).all()  # pad rows included
    if q.dtype == torch.bfloat16:
        # exp(s - running max) rounds to bf16 before P·V in the kernel,
        # exp(s - final max) in the plain version; both round the output:
        # 2 bf16 ulps at |out| < 4, plus 1% for the rounding of P
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=1e-2)
    else:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)  # summation order


@pytest.mark.parametrize("b,h,l,d,dtype", [
    (2, 4, 128, 128, torch.bfloat16),
    (3, 2, 200, 128, torch.bfloat16),   # ragged L: a partial last tile
    (2, 2, 64, 64, torch.bfloat16),     # D = 64
    (2, 3, 77, 64, torch.bfloat16),
    (1, 2, 5, 128, torch.bfloat16),     # shorter than one tile
    (2, 2, 70, 128, torch.float32),
    (2, 2, 33, 64, torch.float32),
])
def test_flash_kernel_matches_plain(cuda, b, h, l, d, dtype):
    from rag_arc_tpu_torch.ops import flash_attention as fa

    q, k, v, seg = _attn_case(b, h, l, d, dtype, cuda)
    before = fa.launches
    got = fa.flash_attention(q, k, v, seg)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    _attn_check(got, q, k, v, seg)


@pytest.mark.parametrize("b,h,hkv,l,d,dtype", [
    (2, 8, 4, 128, 128, torch.bfloat16),   # group 2: two heads share each K/V tile
    (3, 4, 2, 200, 128, torch.bfloat16),   # ragged L
    (2, 8, 2, 77, 64, torch.bfloat16),     # group 4, D = 64
    (2, 6, 2, 130, 128, torch.bfloat16),   # group 3: 128 rows of one head a block
    (2, 4, 1, 70, 64, torch.bfloat16),     # one KV head
    (1, 16, 8, 5, 128, torch.bfloat16),    # shorter than one tile
    (2, 4, 2, 70, 128, torch.float32),
    (2, 6, 2, 33, 64, torch.float32),
])
def test_flash_kernel_gqa_matches_plain(cuda, b, h, hkv, l, d, dtype):
    from rag_arc_tpu_torch.ops import flash_attention as fa

    q, k, v, seg = _gqa_case(b, h, hkv, l, d, dtype, cuda)
    before = fa.launches
    got = fa.flash_attention(q, k, v, seg)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    _attn_check(got, q, k, v, seg)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hkv", [4, 2])
def test_flash_kernel_writes_through_out_strides(cuda, dtype, hkv):
    """out= a (B, L, H, D) buffer seen as (B, H, L, D): every element
    written in place, the buffer returned."""
    from rag_arc_tpu_torch.ops import flash_attention as fa

    q, k, v, seg = _gqa_case(3, 4, hkv, 150, 128, dtype, cuda, seed=4)
    buf = torch.full((3, 150, 4, 128), float("nan"), dtype=dtype, device=cuda)
    got = fa.flash_attention(q, k, v, seg, out=buf.transpose(1, 2))
    torch.cuda.synchronize()
    assert got.data_ptr() == buf.data_ptr() and not torch.isnan(buf).any()
    _attn_check(buf.transpose(1, 2), q, k, v, seg)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_not_causal(cuda, dtype):
    from rag_arc_tpu_torch.ops import flash_attention as fa

    q, k, v, seg = _attn_case(2, 2, 150, 128, dtype, cuda, seed=1)
    got = fa.flash_attention(q, k, v, seg, causal=False)
    torch.cuda.synchronize()
    _attn_check(got, q, k, v, seg, causal=False)


def test_flash_kernel_pad_rows_attend_only_pads(cuda):
    from rag_arc_tpu_torch.ops import flash_attention as fa

    q, k, v, seg = _attn_case(2, 2, 96, 128, torch.bfloat16, cuda, seed=2)
    seg[1] = (torch.arange(96, device=cuda) >= 70).int()
    got = fa.flash_attention(q, k, v, seg)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[1, :, 0], v[1, :, 0], atol=0, rtol=0)  # sees itself only
    _attn_check(got, q, k, v, seg)


@pytest.mark.parametrize("offset", [1, 8])
def test_flash_kernel_on_offset_views(cuda, offset):
    from rag_arc_tpu_torch.ops import flash_attention as fa

    q, k, v, seg = _attn_case(2, 2, 100, 128, torch.bfloat16, cuda, seed=3)
    views = []
    for t in (q, k, v):
        flat = torch.cat([t.new_zeros(offset), t.flatten()])
        views.append(flat[offset:].view(t.shape))
    got = fa.flash_attention(*views, seg)
    torch.cuda.synchronize()
    _attn_check(got, q, k, v, seg)


def test_flash_wrapper_refuses(cuda):
    from rag_arc_tpu_torch.ops import flash_attention as fa

    q, k, v, seg = _attn_case(2, 2, 64, 128, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, seg)
    with pytest.raises(ValueError, match="head dim"):
        x = torch.zeros(2, 2, 64, 32, device=cuda, dtype=torch.bfloat16)
        fa.flash_attention(x, x, x, seg)
    with pytest.raises(ValueError, match="all bf16 or all f32"):
        fa.flash_attention(q.half(), k.half(), v.half(), seg)
    with pytest.raises(ValueError, match="int32"):
        fa.flash_attention(q, k, v, seg.long())


# -- the Qwen3 forward on the card ------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qwen3_kernel_path_close_to_einsum(cuda, dtype):
    """A 2-layer Qwen3 at D=128 on the card: the kernel path ("auto")
    against the einsum reference on the same weights, and both kernels
    launched once per layer."""
    from rag_arc_tpu_torch.models import qwen3 as tq
    from rag_arc_tpu_torch.ops import flash_attention as fa
    from rag_arc_tpu_torch.ops import rope_prep as rp

    cfg = tq.Qwen3Config(vocab_size=1000, hidden_size=256, intermediate_size=512,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                         head_dim=128, dtype=dtype, param_dtype=dtype)
    model = tq.init_qwen3(cfg, 0, cuda)
    ref = tq.Qwen3LM(dataclasses.replace(cfg, attn_impl="einsum"), device=cuda)
    ref.load_state_dict(model.state_dict())
    gen = torch.Generator(device="cpu").manual_seed(1)
    ids = torch.randint(4, 1000, (5, 90), generator=gen).to(cuda)
    mask = (torch.arange(90)[None, :] >= torch.tensor([0, 10, 50, 80, 89])[:, None]).to(cuda)
    r0, f0 = rp.launches, fa.launches
    with torch.no_grad():
        got = model.last_logits(ids, mask).float()
    torch.cuda.synchronize()
    assert rp.launches - r0 == 2 and fa.launches - f0 == 2
    with torch.no_grad():
        want = ref.last_logits(ids, mask).float()
    assert torch.isfinite(got).all()
    # bf16: the two paths round at different points (models/qwen3.py)
    atol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got, want, atol=atol, rtol=0)


def test_qwen3_forward_launches_each_kernel_once_a_layer(cuda, monkeypatch):
    """A Qwen3 forward on the card: one rope_prep launch (KV heads written
    once) and one flash_attention launch (KV heads read directly, output
    written in place) per layer, and no plain version."""
    from rag_arc_tpu_torch.models import qwen3 as tq
    from rag_arc_tpu_torch.ops import flash_attention as fa
    from rag_arc_tpu_torch.ops import rope_prep as rp

    plain_calls = []
    for mod, name in ((rp, "rope_prep_plain"), (fa, "attention_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **kw:
                            (plain_calls.append(_n), _fn(*a, **kw))[1])
    seen = []
    rope = tq.rope_prep
    monkeypatch.setattr(tq, "rope_prep", lambda *a, **kw: (
        seen.append(("rope", kw.get("repeat_kv", True))), rope(*a, **kw))[1])
    flash = tq.flash_attention
    monkeypatch.setattr(tq, "flash_attention", lambda q, k, v, seg, **kw: (
        seen.append(("flash", k.shape[1], kw["out"].transpose(1, 2).is_contiguous())),
        flash(q, k, v, seg, **kw))[1])
    cfg = tq.Qwen3Config(vocab_size=1000, hidden_size=512, intermediate_size=512,
                         num_hidden_layers=3, num_attention_heads=8, num_key_value_heads=2,
                         head_dim=64, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    model = tq.init_qwen3(cfg, 0, cuda)
    ids = torch.randint(4, 1000, (4, 100), device=cuda)
    r0, f0 = rp.launches, fa.launches
    with torch.no_grad():
        logits = model.last_logits(ids, torch.ones_like(ids, dtype=torch.bool))
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all()
    assert (rp.launches - r0, fa.launches - f0) == (3, 3)
    assert plain_calls == []
    assert seen == [("rope", False), ("flash", 2, True)] * 3


# -- the kernel probe's kernels: piped producer, fused top-k, corpus stream ------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 7, 70, 130])
@pytest.mark.parametrize("n,d,g", [(4096, 64, 16), (4096, 64, 128), (1056, 96, 16),
                                   (1056, 96, 32)])  # 1056: a ragged last tile
def test_piped_matches_plain(cuda, dtype, b, n, d, g):
    q, x, valid = _inputs(n, d, b, dtype, cuda)
    before = smp.launches
    got = smp.subtile_max_piped(q, x, valid, g)
    torch.cuda.synchronize()
    assert smp.launches == before + 1
    torch.testing.assert_close(got, sm.subtile_max_plain(q, x, valid, g), atol=1e-4, rtol=0)


@pytest.mark.parametrize("b", [1, 70])
@pytest.mark.parametrize("n,d", [(4096, 64), (2048, 1040)])
@pytest.mark.parametrize("g", [16, 32])
def test_piped_int8_equals_plain(cuda, b, n, d, g):
    rng = np.random.default_rng(b + d)
    codes = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8)).to(cuda)
    q = torch.from_numpy(rng.integers(-127, 128, (b, d)).astype(np.int8)).to(cuda)
    scale = torch.from_numpy(np.repeat(rng.random(n // 32).astype(np.float32), 32)).to(cuda)
    valid = torch.from_numpy(rng.random(n) > 0.05).to(cuda)
    valid[64:96] = False
    got = smp.subtile_max_piped(q, codes, valid, g, scale=scale)
    torch.cuda.synchronize()
    want = smi8.subtile_max_i8_plain(q, codes, scale, valid, g, block_scales=True)
    assert torch.equal(got, want)


def test_piped_g256_and_refusals(cuda):
    q, x, valid = _inputs(4096, 64, 9, torch.bfloat16, cuda)
    got = smp.subtile_max_piped(q, x, valid, 256)
    torch.testing.assert_close(got, sm.subtile_max_plain(q, x, valid, 256), atol=1e-4, rtol=0)
    # d = 100 is no longer refused: the wrapper pads it for TMA
    q, x, valid = _inputs(1024, 100, 4, torch.bfloat16, cuda)
    got = smp.subtile_max_piped(q, x, valid, 16)
    torch.testing.assert_close(got, sm.subtile_max_plain(q, x, valid, 16), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="must share"):
        smp.subtile_max_piped(q.float(), x, valid, 16)
    with pytest.raises(ValueError, match="contiguous"):
        smp.subtile_max_piped(q.T.contiguous().T, x, valid, 16)


@pytest.mark.parametrize("b", [1, 7, 130, 512])
@pytest.mark.parametrize("g", [16, 32, 64, 128, 256])
def test_piped_batches_and_widths(cuda, b, g):
    """The ping-pong kernel at every g (128 and 256 served from g = 64), a
    ragged query block and whole dead sub-tiles: one launch a call."""
    q, x, valid = _inputs(8192, 64, b, torch.bfloat16, cuda, seed=b + g)
    valid[1024:1536] = False
    x[~valid] = 0
    before = smp.launches
    got = smp.subtile_max_piped(q, x, valid, g)
    torch.cuda.synchronize()
    assert smp.launches == before + 1
    torch.testing.assert_close(got, sm.subtile_max_plain(q, x, valid, g), atol=1e-4, rtol=0)
    torch.testing.assert_close(got, sm.subtile_max(q, x, valid, g), atol=1e-4, rtol=0)
    assert (got[:, 1024 // g : 1536 // g] == sm.NEG).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d,offset", [(100, 0), (64, 3), (100, 5)])
def test_piped_on_padded_and_offset_operands(cuda, dtype, d, offset):
    """The wrapper's TMA copies: d = 100 zero-padded, views off a 16-byte
    boundary; int8 bit for bit."""
    rng = np.random.default_rng(d + offset)
    n, b = 4096, 33
    if dtype == torch.int8:
        x = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8)).to(cuda)
        q = torch.from_numpy(rng.integers(-127, 128, (b, d)).astype(np.int8)).to(cuda)
        valid = torch.from_numpy(rng.random(n) > 0.05).to(cuda)
        scale = torch.from_numpy(np.repeat(rng.random(n // 16).astype(np.float32), 16)).to(cuda)
    else:
        q, x, valid = _inputs(n, d, b, dtype, cuda, seed=d + offset)
        scale = None
    qv = torch.cat([q.new_zeros(offset), q.flatten()])[offset:].view(q.shape)
    xv = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(x.shape)
    got = smp.subtile_max_piped(qv, xv, valid, 16, scale=scale)
    torch.cuda.synchronize()
    want = smp.subtile_max_piped_plain(q, x, valid, 16, scale=scale)
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("b", [1, 7, 130, 512])
@pytest.mark.parametrize("g", [16, 64, 256])
def test_piped_int8_equals_subtile_max_i8_kernel(cuda, b, g):
    rng = np.random.default_rng(b * g)
    n, d = 8192, 768
    codes = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8)).to(cuda)
    q = torch.from_numpy(rng.integers(-127, 128, (b, d)).astype(np.int8)).to(cuda)
    scale = torch.from_numpy(np.repeat(rng.random(n // g).astype(np.float32), g)).to(cuda)
    valid = torch.from_numpy(rng.random(n) > 0.05).to(cuda)
    valid[2048:2560] = False
    before = smp.launches
    got = smp.subtile_max_piped(q, codes, valid, g, scale=scale)
    torch.cuda.synchronize()
    assert smp.launches == before + 1
    assert torch.equal(got, smi8.subtile_max_i8(q, codes, scale, valid, g))
    assert torch.equal(got, smi8.subtile_max_i8_plain(q, codes, scale, valid, g))


@pytest.mark.parametrize("producer", ["stream", "stream_piped", "scan"])
def test_two_level_producers_on_card(cuda, producer):
    q, x, valid = _inputs(8192, 64, 33, torch.bfloat16, cuda, seed=2)
    s1, p1 = two_level_topk(q.float(), x, valid, 10, producer=producer)
    s2, p2 = masked_topk(q.float(), x, valid, 10)
    torch.testing.assert_close(p1, p2, atol=0, rtol=0)
    torch.testing.assert_close(s1, s2, atol=1e-5, rtol=0)


def _int_inputs(n, d, b, device, seed=0):
    # small integers: every dot is exact in bf16 products and f32 sums, in
    # any order, so kernel and plain version agree bit for bit, ties too
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, (n, d)).astype(np.float32)
    q = rng.integers(-2, 3, (b, d)).astype(np.float32)
    valid = rng.random(n) > 0.05
    sq = (x * x).sum(1).astype(np.float32)
    return (torch.from_numpy(q).to(device), torch.from_numpy(x).to(device, torch.bfloat16),
            torch.from_numpy(valid).to(device), torch.from_numpy(sq).to(device))


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("skip,packed", [(False, False), (True, False), (True, True),
                                         (False, True)])
@pytest.mark.parametrize("b,k", [(5, 10), (130, 4), (3, 128), (1, 1), (7, 10), (256, 100),
                                 (257, 128), (512, 10)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_equals_plain_on_integer_data(cuda, metric, skip, packed, b, k, dtype):
    """Integer data: every dot exact in any order, so scores tie within
    and across splits (8192 rows in 64-row tiles: a split boundary inside
    every 1024-row packed tile) and the result is bit for bit the plain
    version's, at small and large B and k, both query-block layouts."""
    q, x, valid, sq = _int_inputs(8192, 32, b, cuda)
    x = x.to(dtype)
    before = fm.launches
    got_s, got_p = fm.fused_mips_topk(q, x, valid, sq, k, tile_n=1024, metric=metric,
                                      skip_tiles=skip, packed=packed)
    torch.cuda.synchronize()
    assert fm.launches == before + 1
    want_s, want_p = fm.fused_mips_topk_plain(q, x, valid, sq, k, 1024, metric, skip, packed)
    assert torch.equal(got_p, want_p)
    assert torch.equal(got_s, want_s)


def test_fused_split_boundaries_fall_inside_packed_tiles(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = fm.schedule(8192, 5, 10, sms, torch.bfloat16)
    cuts = {s * plan.per * plan.rows for s in range(1, plan.splits)}
    assert any(c % 1024 for c in cuts)


def _topk_equal_up_to_kth_ties(got, want, slack):
    """ids equal except between candidates within `slack` of the k-th
    score; scores within `slack`."""
    gs, gp = (t.cpu() for t in got)
    ws, wp = (t.cpu() for t in want)
    assert float((gs - ws).abs().max()) <= slack
    for i in range(gp.shape[0]):
        diff = set(gp[i].tolist()) ^ set(wp[i].tolist())
        score = dict(zip(gp[i].tolist() + wp[i].tolist(), gs[i].tolist() + ws[i].tolist()))
        assert all(abs(score[p] - float(ws[i, -1])) <= slack for p in diff), i


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
def test_fused_matches_plain(cuda, dtype, metric):
    q, x, valid = _inputs(8192, 64, 70, dtype, cuda, seed=3)
    sq = (x.float() * x.float()).sum(1)
    got_s, got_p = fm.fused_mips_topk(q.float() * 2, x, valid, sq, 10, tile_n=2048,
                                      metric=metric, skip_tiles=True)
    want_s, want_p = fm.fused_mips_topk_plain(q.float() * 2, x, valid, sq, 10, 2048, metric,
                                              True, False)
    assert torch.equal(got_p, want_p)
    torch.testing.assert_close(got_s, want_s, atol=1e-5, rtol=0)


@pytest.mark.parametrize("b", [1, 7, 256, 257, 512])
@pytest.mark.parametrize("k", [1, 10, 100, 128])
@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
def test_fused_batches_and_k(cuda, b, k, metric):
    q, x, valid = _inputs(16384, 64, b, torch.bfloat16, cuda, seed=b + k)
    sq = (x.float() * x.float()).sum(1)
    for skip, packed in ((False, False), (True, True)):
        got = fm.fused_mips_topk(q, x, valid, sq, k, tile_n=2048, metric=metric,
                                 skip_tiles=skip, packed=packed)
        want = fm.fused_mips_topk_plain(q, x, valid, sq, k, 2048, metric, skip, packed)
        if packed:  # equal quanta up to the summation order: compare keys
            bits = fm.packed_bits(2048, True)
            kq = lambda s: (fm.quantize_keys(s, bits).long() >> bits).double()  # noqa: E731
            _topk_equal_up_to_kth_ties((kq(got[0]), got[1]), (kq(want[0]), want[1]), 1.0)
        else:
            _topk_equal_up_to_kth_ties(got, want, 1e-5)
        assert not bool(torch.isin(got[1], torch.nonzero(~valid).flatten()).any())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,offset", [(100, 0), (32, 3), (100, 5)])
def test_fused_on_padded_and_offset_operands(cuda, dtype, d, offset):
    q, x, valid, sq = _int_inputs(4096, d, 9, cuda, seed=d + offset)
    x = x.to(dtype)
    q = q.to(dtype)
    qv = torch.cat([q.new_zeros(offset), q.flatten()])[offset:].view(q.shape)
    xv = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(x.shape)
    got = fm.fused_mips_topk(qv, xv, valid, sq, 10, tile_n=1024, metric="l2", packed=True)
    torch.cuda.synchronize()
    want = fm.fused_mips_topk_plain(q, x, valid, sq, 10, 1024, "l2", False, True)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_fused_fewer_live_rows_than_k_and_refusals(cuda):
    q, x, valid, sq = _int_inputs(4096, 32, 4, cuda, seed=1)
    valid[:] = False
    valid[[5, 2000, 4000]] = True
    s, p = fm.fused_mips_topk(q, x, valid, sq, 10, tile_n=1024, metric="ip")
    assert (p[:, 3:] == -1).all() and (s[:, 3:] == fm.NEG).all()
    assert set(p[0, :3].tolist()) == {5, 2000, 4000}
    with pytest.raises(ValueError, match="k must be"):
        fm.fused_mips_topk(q, x, valid, sq, fm.MAX_K + 1, tile_n=1024)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
@pytest.mark.parametrize("n", [4096, 1003, 7])
def test_corpus_stream_equals_plain(cuda, dtype, n):
    rng = np.random.default_rng(n)
    if dtype == torch.int8:
        x = torch.from_numpy(rng.integers(-127, 128, (n, 48)).astype(np.int8)).to(cuda)
    else:
        x = torch.from_numpy(rng.standard_normal((n, 48)).astype(np.float32)).to(cuda, dtype)
    before = cst.launches
    got = cst.corpus_stream(x)
    torch.cuda.synchronize()
    assert cst.launches == before + 1
    assert torch.equal(got, cst.corpus_stream_plain(x))


# -- sparse and hybrid retrieval (BM25, the transfer pool) -----------------------


def _bm25_slab(b, n, seed):
    """BM25-like scores: a few distinct values (ties past the k-th slot),
    -inf columns, an all -inf row, and zeros."""
    rng = np.random.default_rng(seed)
    s = rng.choice(np.array([0.0, 0.5, 1.25, 3.0, 7.5], np.float32), (b, n))
    s[rng.random((b, n)) < 0.2] = -np.inf
    s[-1] = -np.inf
    s[0, :3] = -np.inf
    return torch.from_numpy(s.astype(np.float32))


@pytest.mark.parametrize("b,n,k", [(8, 4096, 10), (5, 2048, 300), (3, 1000, 7),
                                   (64, 2_000_896, 10), (4, 1024, 1024)])
def test_bm25_select_topk_kernel_equals_plain(cuda, b, n, k):
    """select_topk on a CUDA tensor (the select kernel: over group maxima
    where a group width divides N, else over the raw scores) against the
    plain tournament on the CPU, -inf and ties included: values equal, ids
    equal once -inf slots map to -1 (the kernel path returns -1 there)."""
    from rag_arc_tpu_torch.ops import bm25 as ob

    s = _bm25_slab(b, n, seed=n + k)
    before = ss.launches
    gv, gp = ob.select_topk(s.to(cuda), k)
    torch.cuda.synchronize()
    assert ss.launches == before + 1
    wv, wp = ob.select_topk(s, k)
    assert torch.equal(gv.cpu(), wv)
    assert torch.equal(gp.cpu(), torch.where(torch.isneginf(wv), -1, wp))


def test_bm25_head_is_full_f32_with_tf32_on(cuda):
    """The head matmul ignores a global TF32 setting, and leaves it as it
    found it. Weights 1 + r·2^-12 (r < 8) are exact in f32 and round to 1
    in TF32's 10-bit mantissa; every partial sum of their products with
    counts 0..2 over 256 terms is exact in f32, so the full-f32 product is
    exact and a TF32 one is off by at least 2^-12 wherever r·q > 0."""
    from rag_arc_tpu_torch.ops import bm25 as ob

    rng = np.random.default_rng(0)
    w = (1.0 + rng.integers(1, 8, (256, 65536)) * 2.0**-12).astype(np.float32)
    q = rng.integers(0, 3, (64, 256)).astype(np.float32)
    want = torch.from_numpy((q.astype(np.float64) @ w.astype(np.float64)).astype(np.float32))
    qd, wd = torch.from_numpy(q).to(cuda), torch.from_numpy(w).to(cuda)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = ob.head_scores(qd, wd)
        assert torch.backends.cuda.matmul.allow_tf32
        tf32 = qd @ wd
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert torch.equal(got.cpu(), want)
    assert not torch.equal(tf32.cpu(), want)  # the flag was on: TF32 rounds


def test_transfer_pool_pinned_flush_equals_cpu(cuda):
    from rag_arc_tpu_torch.utils import transfers

    gen = torch.Generator(device=cuda).manual_seed(0)
    trees = [(torch.randn((33, 7), generator=gen, device=cuda),
              torch.randint(-5, 5, (33, 7), generator=gen, device=cuda)),
             {"a": torch.randn(1000, generator=gen, device=cuda).to(torch.float16),
              "b": torch.arange(5, device=cuda, dtype=torch.int32)[1:]},
             torch.rand((4, 4), generator=gen, device=cuda) > 0.5]
    want = [(t[0].cpu().numpy(), t[1].cpu().numpy()) if isinstance(t, tuple)
            else {k: v.cpu() for k, v in t.items()} if isinstance(t, dict)
            else t.cpu().numpy() for t in trees]
    pool = transfers.TransferPool()
    handles = [pool.register(t) for t in trees]
    got = [pool.result(h) for h in handles]
    assert pool.flushes == 1
    np.testing.assert_array_equal(got[0][0], want[0][0])
    np.testing.assert_array_equal(got[0][1], want[0][1])
    np.testing.assert_array_equal(got[1]["a"], want[1]["a"].numpy())
    np.testing.assert_array_equal(got[1]["b"], want[1]["b"].numpy())
    np.testing.assert_array_equal(got[2], want[2])


@pytest.fixture(scope="module")
def bm25_csr():
    from rag_arc_tpu_torch.tools.bm25_synth import synth_csr

    return synth_csr(np.random.default_rng(0), 20_000, vocab=5_000, mean_len=40)


def test_bm25_every_backend_equals_host_scorer(cuda, bm25_csr):
    """On a small corpus: the doc-major backend, the hybrid backend forced
    to the device (flat and tail-only programs) and routed, each against
    the host C++ scorer; the select kernel launches on the device paths."""
    from rag_arc_tpu_torch.index.bm25 import DeviceBM25Index
    from rag_arc_tpu_torch.tools.bm25_synth import bm25_queries, csr_texts, mixed_queries

    host = DeviceBM25Index(backend="host", device=cuda)
    host.build_from_csr(*bm25_csr)
    rng = np.random.default_rng(1)
    head, sel = bm25_queries(rng, 32, vocab=5_000)
    sel = [[f"w{t}" for t in rng.integers(500, 5_000, size=6)] for _ in range(32)]
    mixed = mixed_queries(head, sel)

    def same(index, queries):
        (gs, gp), (ws, wp) = index.search(queries, 10), host.search(queries, 10)
        np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-5)
        for i in range(len(queries)):
            assert set(gp[i].tolist()) == set(wp[i].tolist()) or np.allclose(
                np.sort(gs[i]), np.sort(ws[i]), rtol=1e-4)

    forced = DeviceBM25Index(backend="hybrid", host_budget=0, device=cuda)
    forced.build_from_csr(*bm25_csr)
    assert forced._hybrid_operands(forced._count_terms(sel))[0]
    assert not forced._hybrid_operands(forced._count_terms(head))[0]
    routed = DeviceBM25Index(backend="hybrid", host_budget=20_000, device=cuda)
    routed.build_from_csr(*bm25_csr)
    doc_major = DeviceBM25Index(backend="device", device=cuda)
    doc_major.build_from_texts_native(csr_texts(*bm25_csr[:3]))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True  # the head stays full f32
    try:
        for index in (forced, routed, doc_major):
            for queries in (head, sel, mixed):
                before = ss.launches
                same(index, queries)
                if index is not routed:
                    assert ss.launches > before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert routed.search_dispatch(mixed, 10).result()[0].shape == (32, 10)


def _post(url, payload):
    import json
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        assert resp.status == 200
        return json.loads(resp.read())


def test_http_batch_takes_the_kernel_path(cuda):
    """A /batch of B=300 over a store whose capacity (2^20 rows) puts the
    score matrix past the direct path's budget: the served answers come
    from the sub-tile-max kernel and the select (one launch each), equal
    to the store's own batched search, each text's source first."""
    import threading

    from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
    from rag_arc_tpu_torch.models.embeddings import HashEmbeddings
    from rag_arc_tpu_torch.serving.app import make_server
    from rag_arc_tpu_torch.serving.pipeline import RagPipeline

    rng = np.random.default_rng(0)
    vocab = [f"w{i}" for i in range(5000)]
    texts = [" ".join(rng.choice(vocab, 12)) for _ in range(4000)]
    store = TorchVectorStore(HashEmbeddings(dim=64), capacity=1 << 20,
                             dtype=torch.bfloat16, device=cuda)
    store.add_texts(texts, ids=[f"d{i}" for i in range(len(texts))])
    assert 4 * 300 * store.index.capacity > store.index.SCORE_BYTES_BUDGET
    pipe = RagPipeline(store.as_retriever(search_kwargs={"k": 10}), top_k=10, batch_max=512)
    pipe.warmup(batch_sizes=(300,))
    srv = make_server(pipe, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        queries = texts[:300]
        sm.launches = ss.launches = 0
        out = _post(f"http://127.0.0.1:{srv.server_port}/batch",
                    {"queries": queries, "response": "ids"})
        assert (sm.launches, ss.launches) == (1, 1)
        got = [[d["id"] for d in r] for r in out["results"]]
        want = [[d.id for d, _ in h]
                for h in store.batch_similarity_search_with_score(queries, k=10)]
        assert got == want
        assert all(r[0] == f"d{i}" for i, r in enumerate(got))
        assert pipe.batcher.stats["max_batch_seen"] == 300
    finally:
        srv.shutdown()


def test_blob_store_round_trips_on_the_card(cuda, tmp_path):
    from rag_arc_tpu_torch.index.blob_docstore import BlobDocstore
    from rag_arc_tpu_torch.index.persistence import load_store, save_store
    from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
    from rag_arc_tpu_torch.models.embeddings import HashEmbeddings

    texts = [f"document number {i} about topic {i % 7}" for i in range(500)]
    ids = [f"d{i}" for i in range(500)]
    emb = HashEmbeddings(dim=48)
    store = TorchVectorStore(emb, dtype=torch.bfloat16, docstore_path=str(tmp_path / "live"),
                             device=cuda)
    store.add_texts(texts, metadatas=[{"i": i} for i in range(500)], ids=ids)
    store.delete(ids[:5])
    save_store(store, tmp_path / "snap")
    want = store.batch_similarity_search_with_score(texts[5:40], k=5)
    for device in (cuda, "cpu"):
        loaded = load_store(tmp_path / "snap", emb, device=device)
        assert isinstance(loaded.docstore, BlobDocstore) and len(loaded) == 495
        assert loaded.index.dtype == torch.bfloat16
        got = loaded.batch_similarity_search_with_score(texts[5:40], k=5)
        assert [[d.id for d, _ in h] for h in got] == [[d.id for d, _ in h] for h in want]
        assert got[0][0][0].metadata == {"i": 5}
    mmr = loaded.max_marginal_relevance_search(texts[7], k=3, fetch_k=10)
    assert mmr[0].id == "d7" and len({d.id for d in mmr}) == 3


# -- IVF: the probe scan, k-means and the stores -----------------------------------


def _scan_case(cuda, dtype, b, nprobe, nlist=12, lmax=77, d=768, offset=0, seed=0):
    """Lists with dead slots (a ragged Lmax, optionally a view ``offset``
    elements into wider rows) and random probes."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    base = torch.randn((nlist, lmax, d + offset), generator=g, device=cuda)
    lists = (base * 40).clamp(-127, 127).to(torch.int8) if dtype == torch.int8 \
        else base.to(dtype)
    lists = lists[:, :, offset:]
    sqnorm = torch.rand((nlist, lmax), generator=g, device=cuda)
    valid = torch.rand((nlist, lmax), generator=g, device=cuda) > 0.15
    q = torch.randn((b, d), generator=g, device=cuda)
    probe = torch.argsort(torch.rand((b, nlist), generator=g, device=cuda), dim=1)[:, :nprobe]
    cross = torch.randn((b, nlist), generator=g, device=cuda) if dtype == torch.int8 else None
    return q, probe, lists, sqnorm, valid, cross


@pytest.mark.parametrize("dtype,metric", [(torch.float32, "cosine"), (torch.float32, "l2"),
                                          (torch.bfloat16, "ip"), (torch.bfloat16, "l2"),
                                          (torch.int8, "cosine")])
@pytest.mark.parametrize("b,nprobe", [(1, 1), (7, 5), (33, 12)])
@pytest.mark.parametrize("d,offset", [(768, 0), (100, 0), (100, 3)])
def test_ivf_scan_matches_plain(cuda, dtype, metric, b, nprobe, d, offset):
    from rag_arc_tpu_torch.ops import ivf_scan as isc

    q, probe, lists, sqnorm, valid, cross = _scan_case(cuda, dtype, b, nprobe, d=d,
                                                       offset=offset)
    before = isc.launches
    got = isc.ivf_scan(q, probe, lists, sqnorm, valid, metric, cross)
    torch.cuda.synchronize()
    assert isc.launches == before + 1
    want = isc.ivf_scan_plain(q, probe, lists, sqnorm, valid, metric, cross)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    live = torch.isfinite(want)
    # f32 sums in another order over up to d products of magnitude <= ~4e3
    torch.testing.assert_close(got[live], want[live], rtol=1e-5, atol=2e-3)


def test_ivf_scan_writes_into_a_wider_buffer_and_refuses(cuda):
    from rag_arc_tpu_torch.ops import ivf_scan as isc

    q, probe, lists, sqnorm, valid, _ = _scan_case(cuda, torch.bfloat16, 4, 3)
    n = 3 * lists.shape[1]
    buf = torch.full((4, n + 100), 7.0, device=cuda)
    isc.ivf_scan(q, probe, lists, sqnorm, valid, "ip", out=buf[:, :n])
    torch.testing.assert_close(buf[:, :n], isc.ivf_scan_plain(q, probe, lists, sqnorm,
                                                              valid, "ip"), rtol=1e-5,
                               atol=1e-3)
    assert bool((buf[:, n:] == 7.0).all())
    strided = torch.zeros((*lists.shape[:2], 2 * lists.shape[2]), dtype=lists.dtype,
                          device=cuda)[:, :, ::2]
    with pytest.raises(ValueError, match="dense last axis"):
        isc.ivf_scan(q, probe, strided, sqnorm, valid, "ip")
    with pytest.raises(ValueError, match="cross"):
        isc.ivf_scan(q, probe, lists.to(torch.int8), sqnorm, valid, "ip")


def test_kmeans_and_int8_cross_stay_f32_with_tf32_on(cuda):
    from rag_arc_tpu_torch.index.ivf import DeviceIVFIndex
    from rag_arc_tpu_torch.ops.kmeans import kmeans

    rng = np.random.default_rng(0)
    centers = rng.standard_normal((8, 64)).astype(np.float32) * 3
    data = np.concatenate([c + 0.05 * rng.standard_normal((60, 64)).astype(np.float32)
                           for c in centers])
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got_c, got_a = kmeans(data, 8, seed=1, device=cuda)
        want_c, want_a = kmeans(data, 8, seed=1, device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32  # the caller's setting is back
        np.testing.assert_array_equal(got_a, want_a)
        np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-5)
        ivf = DeviceIVFIndex.from_vectors(data, nlist=8, nprobe=8, dtype=torch.int8,
                                          device=cuda)
        cpu = DeviceIVFIndex.from_vectors(data, nlist=8, nprobe=8, dtype=torch.int8,
                                          device="cpu")
        gs, gp = ivf.search(data[::13], 5)
        cs, cp = cpu.search(data[::13], 5)
        np.testing.assert_allclose(gs, cs, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(gp[:, 0], cp[:, 0])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("spill", [1, 2])
def test_ivf_search_equals_all_plain_pipeline(cuda, dtype, spill):
    from rag_arc_tpu_torch.index.ivf import DeviceIVFIndex
    from rag_arc_tpu_torch.ops import ivf_scan as isc
    from rag_arc_tpu_torch.ops import subtile_select as ss

    rng = np.random.default_rng(spill)
    data = rng.standard_normal((5000, 96)).astype(np.float32)
    ivf = DeviceIVFIndex.from_vectors(data, nlist=16, nprobe=4, dtype=dtype, spill=spill,
                                      device=cuda)
    ivf.mark_deleted(np.arange(0, 5000, 11))
    q = torch.from_numpy(rng.standard_normal((33, 96)).astype(np.float32)).to(cuda)
    for nprobe in (1, 4, 16):
        scans, selects = isc.launches, ss.launches
        s, p = ivf.search_sub(q, 10, nprobe)
        torch.cuda.synchronize()
        assert isc.launches == scans + 1 and ss.launches == selects + 1
        ws, wp = ivf.search_sub(q, 10, nprobe, plain=True)
        torch.testing.assert_close(s, ws, rtol=0, atol=1e-4)
        kth = ws[:, -1:]
        same = (p == wp) | ((s - kth).abs() <= 1e-4)  # ties at the k-th score
        assert bool(same.all())
        assert not bool(torch.isin(p, torch.arange(0, 5000, 11, device=cuda)).any())


@pytest.mark.parametrize("index_type", ["ivf", "hnsw"])
def test_ivf_and_hnsw_stores_end_to_end_on_the_card(cuda, index_type, tmp_path):
    from rag_arc_tpu_torch.index.persistence import load_store, save_store
    from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
    from rag_arc_tpu_torch.models.embeddings import HashEmbeddings

    texts = [f"doc {i} about topic {i % 13} and {i % 7}" for i in range(400)]
    store = TorchVectorStore(HashEmbeddings(dim=64), index_type=index_type, nlist=16,
                             nprobe=16, dtype=torch.bfloat16, device=cuda)
    store.add_texts(texts, ids=[f"d{i}" for i in range(400)])
    assert store.index.stats()["kind"] == index_type
    hits = store.batch_similarity_search_with_score(texts[::40], k=5)
    assert [h[0][0].id for h in hits] == [f"d{i}" for i in range(0, 400, 40)]
    store.delete(["d40"])
    assert "d40" not in [d.id for d, _ in store.similarity_search_with_score(texts[40], k=5)]
    assert len(store.max_marginal_relevance_search(texts[7], k=3, fetch_k=10)) == 3
    save_store(store, tmp_path / "snap")
    back = load_store(tmp_path / "snap", HashEmbeddings(dim=64), device=cuda)
    ids = [[d.id for d, _ in h] for h in back.batch_similarity_search_with_score(texts[:9], k=5)]
    assert ids == [[d.id for d, _ in h]
                   for h in store.batch_similarity_search_with_score(texts[:9], k=5)]


# -- the grouped IVF scan: one read of a list for every query that probes it ---------


def _group_case(cuda, dtype, n_queries, d=768, offset=0, nlist=6, lmax=260, seed=0):
    """Every query probes list 2 first and one other list: list 2's group is
    all ``n_queries`` queries. Slots 128-255 of list 2 are dead (a whole
    128-row tile), the last tile is ragged, ~15% of the other slots dead."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    base = torch.randn((nlist, lmax, d + offset), generator=g, device=cuda)
    lists = (base * 40).clamp(-127, 127).to(torch.int8) if dtype == torch.int8 \
        else base.to(dtype)
    lists = lists[:, :, offset:]
    sqnorm = torch.rand((nlist, lmax), generator=g, device=cuda)
    valid = torch.rand((nlist, lmax), generator=g, device=cuda) > 0.15
    valid[2, 128:256] = False
    q = torch.randn((n_queries, d), generator=g, device=cuda)
    other = torch.randint(0, nlist - 1, (n_queries,), generator=g, device=cuda)
    probe = torch.stack([torch.full_like(other, 2), other + (other >= 2).long()], dim=1)
    cross = torch.randn((n_queries, nlist), generator=g, device=cuda) \
        if dtype == torch.int8 else None
    return q, probe, lists, sqnorm, valid, cross


@pytest.mark.parametrize("dtype,metric", [(torch.float32, "cosine"), (torch.float32, "l2"),
                                          (torch.bfloat16, "ip"), (torch.bfloat16, "l2"),
                                          (torch.int8, "cosine")])
@pytest.mark.parametrize("n_queries", [1, 3, 17, 64, 257, 1100])
def test_ivf_scan_one_list_probed_by_many_queries(cuda, dtype, metric, n_queries):
    """Across the CUDA cores' passes, the prologue/CSR limit and, for bf16
    lists, the wgmma crossover (from 9 queries and TC_MIN_GROUP a list)."""
    from rag_arc_tpu_torch.ops import ivf_scan as isc

    q, probe, lists, sqnorm, valid, cross = _group_case(cuda, dtype, n_queries)
    sched = isc.scan_schedule(n_queries, 2, lists.shape[2], lists.shape[0],
                              tc_ok=dtype == torch.bfloat16)
    csr = sched["csr"]
    before, plans = isc.launches, isc.launches_plan
    got = isc.ivf_scan(q, probe, lists, sqnorm, valid, metric, cross)
    torch.cuda.synchronize()
    assert isc.launches == before + 1 and isc.launches_plan == plans + int(csr)
    want = isc.ivf_scan_plain(q, probe, lists, sqnorm, valid, metric, cross)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    live = torch.isfinite(want)
    # f32 sums in another order over up to d products of magnitude <= ~4e3
    torch.testing.assert_close(got[live], want[live], rtol=1e-5, atol=2e-3)


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("n_queries,d", [(11, 768), (40, 768), (64, 768), (65, 768),
                                         (257, 768), (1100, 768), (300, 96), (300, 776)])
def test_ivf_scan_wgmma_path_matches_plain(cuda, metric, n_queries, d):
    """bf16 lists on the wgmma path, from the fewest queries it takes (11
    over 6 lists: 3.7 a list): a pass of 64 or 128 queries, several
    passes, d off a 64-wide slice, the dead tile and ragged end."""
    from rag_arc_tpu_torch.ops import ivf_scan as isc

    q, probe, lists, sqnorm, valid, _ = _group_case(cuda, torch.bfloat16, n_queries, d=d,
                                                    seed=n_queries)
    assert isc.scan_schedule(n_queries, 2, d, lists.shape[0], True)["tc"]
    before, plans = isc.launches, isc.launches_plan
    n = 2 * lists.shape[1]
    buf = torch.full((n_queries, n + 5), 7.0, device=cuda)
    isc.ivf_scan(q, probe, lists, sqnorm, valid, metric, out=buf[:, :n])
    torch.cuda.synchronize()
    assert isc.launches == before + 1 and isc.launches_plan == plans + 1
    want = isc.ivf_scan_plain(q, probe, lists, sqnorm, valid, metric)
    got = buf[:, :n]
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    live = torch.isfinite(want)
    torch.testing.assert_close(got[live], want[live], rtol=1e-5, atol=2e-3)
    assert bool((buf[:, n:] == 7.0).all())


@pytest.mark.parametrize("dtype,d,offset", [(torch.int8, 768, 0), (torch.bfloat16, 100, 3),
                                            (torch.bfloat16, 768, 3)])
def test_ivf_scan_large_groups_wgmma_cannot_read_take_the_cores(cuda, dtype, d, offset):
    """int8 codes and bf16 views TMA cannot describe stay on the CUDA
    cores at a group size that sends aligned bf16 lists to wgmma."""
    from rag_arc_tpu_torch.ops import ivf_scan as isc

    q, probe, lists, sqnorm, valid, cross = _group_case(cuda, dtype, 40, d=d, offset=offset)
    assert isc.scan_schedule(40, 2, d, lists.shape[0], True)["tc"]  # were they aligned bf16
    metric = "cosine" if dtype == torch.int8 else "ip"
    before, plans = isc.launches, isc.launches_plan
    got = isc.ivf_scan(q, probe, lists, sqnorm, valid, metric, cross)
    torch.cuda.synchronize()
    assert isc.launches == before + 1 and isc.launches_plan == plans  # 80 pairs: no CSR
    want = isc.ivf_scan_plain(q, probe, lists, sqnorm, valid, metric, cross)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    live = torch.isfinite(want)
    torch.testing.assert_close(got[live], want[live], rtol=1e-5, atol=2e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("n_queries", [5, 600])
def test_ivf_scan_grouped_on_offset_views_into_a_wider_buffer(cuda, dtype, n_queries):
    """d = 100 views 3 elements into wider rows (scalar loads), deleted rows
    in every list, and ``out=`` the front of a wider buffer."""
    from rag_arc_tpu_torch.ops import ivf_scan as isc

    q, probe, lists, sqnorm, valid, cross = _group_case(cuda, dtype, n_queries, d=100,
                                                        offset=3, seed=1)
    valid[:, ::7] = False
    metric = "cosine" if dtype == torch.int8 else "ip"
    n = 2 * lists.shape[1]
    buf = torch.full((n_queries, n + 77), 7.0, device=cuda)
    isc.ivf_scan(q, probe, lists, sqnorm, valid, metric, cross, out=buf[:, :n])
    want = isc.ivf_scan_plain(q, probe, lists, sqnorm, valid, metric, cross)
    assert torch.equal(torch.isneginf(buf[:, :n]), torch.isneginf(want))
    live = torch.isfinite(want)
    torch.testing.assert_close(buf[:, :n][live], want[live], rtol=1e-5, atol=2e-3)
    assert bool((buf[:, n:] == 7.0).all())


@pytest.mark.parametrize("b,nprobe", [(1, 3), (300, 4)])
def test_ivf_scan_a_block_a_pair_with_more_lists_than_pairs(cuda, b, nprobe):
    """nlist past B·nprobe: the grid takes one row a (b, p) pair, the
    list's first pair scoring it for the whole group (prologue and CSR)."""
    from rag_arc_tpu_torch.ops import ivf_scan as isc

    q, probe, lists, sqnorm, valid, _ = _scan_case(cuda, torch.bfloat16, b, nprobe,
                                                   nlist=2000, lmax=40, d=64, seed=b)
    probe[: b // 2, 0] = 7  # half the queries share a list
    probe = torch.where((probe == 7) & (torch.arange(nprobe, device=cuda) > 0), 8, probe)
    sched = isc.scan_schedule(b, nprobe, 64, 2000)
    assert sched["by_pair"] and sched["csr"] is (b * nprobe > isc.PROLOGUE_MAX)
    got = isc.ivf_scan(q, probe, lists, sqnorm, valid, "ip")
    want = isc.ivf_scan_plain(q, probe, lists, sqnorm, valid, "ip")
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    live = torch.isfinite(want)
    torch.testing.assert_close(got[live], want[live], rtol=1e-5, atol=2e-3)


@pytest.mark.parametrize("b,nprobe,nlist", [(1, 1, 1), (1, 9, 16), (40, 30, 31), (1100, 8, 100),
                                            (3000, 2, 5)])
def test_probe_plan_kernel_matches_plain(cuda, b, nprobe, nlist):
    from rag_arc_tpu_torch.ops import ivf_scan as isc

    g = torch.Generator(device=cuda).manual_seed(b)
    probe = torch.argsort(torch.rand((b, nlist), generator=g, device=cuda), dim=1)[:, :nprobe]
    before = isc.launches_plan
    offsets, pairs = isc.probe_plan(probe, nlist)
    torch.cuda.synchronize()
    assert isc.launches_plan == before + 1
    w_off, w_pairs = isc.probe_plan_plain(probe, nlist)
    assert torch.equal(offsets, w_off)
    for c in range(nlist):  # pairs within a list come in any order
        lo, hi = int(w_off[c]), int(w_off[c + 1])
        assert torch.equal(torch.sort(pairs[lo:hi]).values, w_pairs[lo:hi])


def test_kernel_constants_match_the_wrappers(cuda):
    from rag_arc_tpu_torch.ops import ivf_scan as isc

    lib = isc.load().lib
    assert lib.ivf_scan_prologue_max() == isc.PROLOGUE_MAX
    assert lib.ivf_scan_pass_max() == isc.PASS_MAX
    lib = ss.load().lib
    assert lib.subtile_select_fast_k1() == ss.FAST_K1
    assert lib.subtile_select_stage() == ss.STAGE


# -- the streamed select: the ring and the row's unaligned ends -----------------------


@pytest.mark.parametrize("b", [1, 33, 160, 512])
@pytest.mark.parametrize("c,k", [(5, 5), (1000, 10), (2047, 100), (2047, 2047),
                                 (125_003, 10), (125_003, 100)])
def test_streamed_select_equals_plain(cuda, b, c, k):
    """C below one ring stage, C not a multiple of a stage (rows off a
    16-byte boundary), k = C; the slab's -0.0/+0.0, tie and all-NEG rows."""
    x = _select_slab(b, c, k, cuda, seed=b + c + k)
    before = ss.launches
    got = ss.iterative_argmax_resid(x, k)
    torch.cuda.synchronize()
    assert ss.launches == before + 1
    _select_equal(got, ss.iterative_argmax_resid_plain(x, k), c)


@pytest.mark.parametrize("b,c,k", [(1, 125_003, 10), (33, 125_000, 100), (33, 40_000, 1000),
                                   (7, 70_001, 1)])
def test_select_on_a_view_off_a_16_byte_boundary(cuda, b, c, k):
    # a view 3 floats into its storage: row 0 starts off a 16-byte boundary
    x = _select_slab(b, c, k, cuda, seed=k)
    flat = torch.empty(b * c + 3, device=cuda)
    flat[3:] = x.reshape(-1)
    x = flat[3:].view(b, c)
    _select_equal(ss.iterative_argmax_resid(x, k), ss.iterative_argmax_resid_plain(x, k), c)


@pytest.mark.parametrize("k", [ss.FAST_K1 - 1, ss.FAST_K1])
def test_select_at_the_shared_buffer_limit(cuda, k):
    """k + 1 = FAST_K1 (the last k the shared buffer takes) and one past it
    (the global-scratch route), held to a stable descending sort."""
    c = 9000
    x = _select_slab(7, c, k, cuda, seed=k)
    gi, gl, gr = ss.iterative_argmax_resid(x, k)
    order = torch.sort(x + 0.0, dim=1, descending=True, stable=True)
    wl = order.values[:, :k] > ss.NEG * 0.5
    _select_equal((gi, gl, gr), (order.indices[:, :k], wl,
                                 torch.clamp(order.values[:, k], min=ss.NEG)), c)


# -- GraphRAG on the card: the merge's self-search, and BERT -------------------------


def test_graph_merge_on_the_card_launches_both_kernels(cuda, monkeypatch):
    """The hard merge corpus (n = 5,000, d = 64) with every self-search
    chunk forced onto the two-level path: one f32 ``subtile_max`` and one
    select launch a 4,096-query chunk; the pair set equals a CPU store's
    (the plain versions) except at ties within 1e-5 of the threshold or of
    a row's k-th score; with equal pairs the merges are equal; no dangling
    edges, no entity self-loops."""
    from rag_arc_tpu_torch.tools import graph_merge_bench as gmb

    monkeypatch.setattr(DeviceFlatIndex, "_force_two_level", True)
    corpus = gmb.hard_corpus(5000, 64, seed=0)
    stores = [gmb.planted_store(corpus.names, corpus.vecs, device=dev, edges=corpus.edges)[0]
              for dev in (cuda, "cpu")]
    for store in stores:
        store.generate_embeddings()
    card, host = stores
    assert card._indexes["entity"].emb.dtype == torch.float32
    before = (sm.launches, ss.launches)
    got = {(a, b): s for a, b, s in card._similar_pairs("entity", 0.95, 10)}
    assert (sm.launches - before[0], ss.launches - before[1]) == (2, 2)
    want = {(a, b): s for a, b, s in host._similar_pairs("entity", 0.95, 10)}
    kth = {}
    for store in stores:  # each row's 11th score: the top-k boundary
        pos = store._positions["entity"]
        index = store._indexes["entity"]
        s, _ = index.search(index.take(np.asarray(list(pos.values()))), 11)
        for key, row in zip(pos, s):
            kth.setdefault(key, []).append(float(row[-1]))
    for pair in set(got) ^ set(want):
        score = got.get(pair, want.get(pair))
        bounds = (0.95, *kth[pair[0]], *kth[pair[1]])
        assert any(abs(score - v) <= 1e-5 for v in bounds), (pair, score)
    assert all(abs(got[p] - want[p]) <= 1e-5 for p in set(got) & set(want))
    merged = [store.merge_duplicate_entities() for store in stores]
    report = gmb.hard_report(card, corpus)
    assert report["dangling_edges"] == 0 and report["entity_self_loops"] == 0
    if set(got) == set(want):
        assert merged[0] == merged[1] and report == gmb.hard_report(host, corpus)


def test_bert_on_the_card_matches_the_cpu(cuda):
    """f32 BERT (TF32 off) on the card against the same weights on the CPU."""
    from rag_arc_tpu_torch.models.bert import BertConfig, BertModel, init_bert

    cfg = BertConfig(vocab_size=1000, hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=512, max_position_embeddings=64)
    host = init_bert(cfg, 0, "cpu")
    card = BertModel(cfg, device=cuda).eval()
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 1000, (8, 48)))
    mask = torch.from_numpy(np.arange(48)[None, :] < rng.integers(8, 49, 8)[:, None])
    with torch.no_grad():
        h_cpu, p_cpu = host(ids, mask)
        h_gpu, p_gpu = card(ids.to(cuda), mask.to(cuda))
    live = mask.numpy()
    np.testing.assert_allclose(h_gpu.cpu().numpy()[live], h_cpu.numpy()[live], atol=1e-4)
    np.testing.assert_allclose(p_gpu.cpu().numpy(), p_cpu.numpy(), atol=1e-4)
