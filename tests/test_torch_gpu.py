"""Card-only tests of the port's CUDA kernels (sub-tile max bf16/f32 with
its l2 mode, int8, rope_prep, flash attention, the pipelined producer,
the fused top-k and the corpus stream): each kernel against its
plain PyTorch version at small shapes (int8 bit for bit), offset views
and ragged lengths, the launch counts, the wrappers' refusals, and a
small Qwen3 forward through both attention kernels. They skip where no
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
        want = ref.last_logits(ids, mask).float()
    torch.cuda.synchronize()
    assert rp.launches - r0 == 2 and fa.launches - f0 == 2
    assert torch.isfinite(got).all()
    # bf16: the two paths round at different points (models/qwen3.py)
    atol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got, want, atol=atol, rtol=0)


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
    q, x, valid = _inputs(1024, 100, 4, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="16 bytes"):
        smp.subtile_max_piped(q, x, valid, 16)


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
@pytest.mark.parametrize("b,k", [(5, 10), (130, 4), (3, 128)])
def test_fused_equals_plain_on_integer_data(cuda, metric, skip, packed, b, k):
    q, x, valid, sq = _int_inputs(8192, 32, b, cuda)
    before = fm.launches
    got_s, got_p = fm.fused_mips_topk(q, x, valid, sq, k, tile_n=1024, metric=metric,
                                      skip_tiles=skip, packed=packed)
    torch.cuda.synchronize()
    assert fm.launches == before + 1
    want_s, want_p = fm.fused_mips_topk_plain(q, x, valid, sq, k, 1024, metric, skip, packed)
    assert torch.equal(got_p, want_p)
    assert torch.equal(got_s, want_s)


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
