"""The reranker path's contracts that this port adds beside the JAX
package's, on the CPU: attention with fewer KV heads than query heads,
``rope_prep(repeat_kv=False)``, ``flash_attention(out=)`` on a strided
view, the sub-tile producer's TMA operand normalisation, and the kernel
build's digest over the shared header.

Inputs are numpy arrays made from a seed; JAX stays on the CPU and is the
reference where one exists (the library's attention reference on
``jnp.repeat``-ed K/V, ``rope_prep_ref``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_arc_tpu_torch.ops import flash_attention as fa
from rag_arc_tpu_torch.ops import rope_prep as rp
from rag_arc_tpu_torch.ops import subtile_max as sm
from rag_arc_tpu_torch.ops._build import source_digest


def _attn(seed, b=3, h=4, hkv=2, l=40, d=64):
    """q (B, H, L, D), k/v (B, HKV, L, D) and left-padded segment ids (the
    mask as int, row 0 unpadded)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, l, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, l, d)).astype(np.float32) for _ in range(2))
    live = rng.integers(1, l + 1, b)
    live[0] = l
    seg = (np.arange(l)[None, :] >= (l - live)[:, None]).astype(np.int32)
    return q, k, v, seg


@pytest.mark.parametrize("h,hkv", [(4, 2), (8, 2), (6, 2)])
@pytest.mark.parametrize("l", [40, 130])
def test_attention_plain_gqa_matches_library_reference(h, hkv, l):
    """Every row, pads included, against the reference of the kernel the
    TPU path calls, fed K/V repeated to every query head."""
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        SegmentIds, mha_reference_no_custom_vjp)

    q, k, v, seg = _attn(0, h=h, hkv=hkv, l=l)
    group = h // hkv
    scale = 1.0 / np.sqrt(q.shape[-1])
    want = mha_reference_no_custom_vjp(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), group, axis=1),
        jnp.repeat(jnp.asarray(v), group, axis=1),
        segment_ids=SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg)),
        causal=True, sm_scale=scale,
    )
    got = fa.attention_plain(*(torch.from_numpy(a) for a in (q, k, v, seg)),
                             causal=True, sm_scale=scale)
    # f32 throughout: summation-order noise
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gqa_is_repeated_kv(causal):
    """The CPU wrapper with HKV < H computes what it computes on K/V
    repeated to H heads, bit for bit, and counts no launch."""
    q, k, v, seg = (torch.from_numpy(a) for a in _attn(1, h=8, hkv=2, l=33))
    before = fa.launches
    got = fa.flash_attention(q, k, v, seg, causal=causal)
    assert fa.launches == before
    want = fa.flash_attention(q, k.repeat_interleave(4, dim=1), v.repeat_interleave(4, dim=1),
                              seg, causal=causal)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_flash_attention_writes_into_a_strided_out():
    q, k, v, seg = (torch.from_numpy(a) for a in _attn(2, h=4, hkv=2, l=24))
    b, h, l, d = q.shape
    buf = torch.full((b, l, h, d), float("nan"))
    out = buf.transpose(1, 2)  # (B, H, L, D) view of a (B, L, H, D) buffer
    got = fa.flash_attention(q, k, v, seg, out=out)
    assert got is out and got.data_ptr() == buf.data_ptr()
    assert not torch.isnan(buf).any()  # every element written
    torch.testing.assert_close(buf.transpose(1, 2), fa.flash_attention(q, k, v, seg),
                               atol=0, rtol=0)


def test_flash_attention_refuses_bad_out_and_heads():
    q, k, v, seg = (torch.from_numpy(a) for a in _attn(3, h=4, hkv=2, l=16))
    with pytest.raises(ValueError, match="out must be"):
        fa.flash_attention(q, k, v, seg, out=torch.empty(3, 4, 16, 32))
    with pytest.raises(ValueError, match="out must be"):
        fa.flash_attention(q, k, v, seg, out=torch.empty_like(q, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="dense last axis"):
        fa.flash_attention(q, k, v, seg, out=torch.empty(3, 4, 64, 16).transpose(2, 3))
    with pytest.raises(ValueError, match="dividing H"):
        fa.flash_attention(q, q[:, :3], q[:, :3], seg)


def _rope(seed, b=3, l=48, nh=8, nkv=2, d=128, dtype="f32"):
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


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("nh,nkv", [(8, 2), (8, 4), (4, 4)])
def test_rope_prep_without_repeat_matches_jax(nh, nkv, dtype):
    """``repeat_kv=False`` against the JAX reference's repeated K/V taken
    at one query head per group (heads ``[::group]``)."""
    from rag_arc_tpu.ops.rope_prep import rope_cos_sin, rope_prep_ref

    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    b, l, d = 3, 48, 128
    group = nh // nkv
    q, k, v, pos, qs, ks = _rope(4, b, l, nh, nkv, d, dtype)
    jcos, jsin = rope_cos_sin(jnp.asarray(pos), 1e6, d)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    ref = rope_prep_ref(jq.reshape(b, l, nh, d), jk.reshape(b, l, nkv, d),
                        jv.reshape(b, l, nkv, d), jcos, jsin, jnp.asarray(qs), jnp.asarray(ks))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = rp.rope_prep(tq, tk, tv, torch.from_numpy(np.array(jcos)),
                       torch.from_numpy(np.array(jsin)), torch.from_numpy(qs),
                       torch.from_numpy(ks), nh=nh, nkv=nkv, d=d, repeat_kv=False)
    assert got[0].shape == (b, nh, l, d)
    assert got[1].shape == got[2].shape == (b, nkv, l, d)
    assert all(t.is_contiguous() and t.dtype == tdt for t in got)
    for g, w in zip(got, (ref[0], ref[1][:, ::group], ref[2][:, ::group])):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if dtype == "bf16":
            # one bf16 ulp of the reference value (both are bf16 numbers)
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
            assert (np.abs(g - w) <= ulp).all()
        else:
            # f32: the norm's summation order, a few f32 ulps at |x| up to ~5
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[2].float().numpy(), np.asarray(ref[2][:, ::group],
                                                                      np.float32))


def test_rope_prep_without_repeat_is_repeat_at_one_head_per_group():
    q, k, v, pos, qs, ks = (torch.from_numpy(a) for a in _rope(5, nh=8, nkv=2, d=64))
    cos, sin = rp.rope_cos_sin(pos, 1e4, 64)
    args = (q, k, v, cos, sin, qs, ks)
    rep = rp.rope_prep(*args, nh=8, nkv=2, d=64)
    once = rp.rope_prep(*args, nh=8, nkv=2, d=64, repeat_kv=False)
    torch.testing.assert_close(once[0], rep[0], atol=0, rtol=0)
    for a, r in zip(once[1:], rep[1:]):
        torch.testing.assert_close(a, r[:, ::4], atol=0, rtol=0)


@pytest.mark.parametrize("d,offset", [(100, 0), (64, 3), (100, 5), (96, 8)])
def test_tma_operands_leave_the_result_unchanged(d, offset):
    """The CUDA wrapper's normalisation of bf16 operands TMA cannot
    describe (d % 8 != 0, a base off a 16-byte boundary): zero-padded
    copies give the plain version's result bit for bit."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((512, d)).astype(np.float32)).bfloat16()
    q = torch.from_numpy(rng.standard_normal((9, d)).astype(np.float32)).bfloat16()
    valid = torch.from_numpy(rng.random(512) > 0.1)
    xv = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(x.shape)
    qv = torch.cat([q.new_zeros(offset), q.flatten()])[offset:].view(q.shape)
    qn, xn = sm.tma_operands(qv, xv)
    width = -(-d // 8) * 8
    assert qn.shape == (9, width) and xn.shape == (512, width)
    assert qn.data_ptr() % 16 == 0 and xn.data_ptr() % 16 == 0
    if width == d and offset % 8 == 0:
        assert qn is qv and xn is xv  # already TMA-friendly: no copy
    for g in (16, 32):
        torch.testing.assert_close(sm.subtile_max_plain(qn, xn, valid, g),
                                   sm.subtile_max_plain(q, x, valid, g), atol=0, rtol=0)
    sq = (x.float() ** 2).sum(1)
    torch.testing.assert_close(sm.subtile_max_plain(qn, xn, valid, 16, sqnorm=sq),
                               sm.subtile_max_plain(q, x, valid, 16, sqnorm=sq), atol=0, rtol=0)


def test_library_name_covers_the_shared_header(tmp_path):
    """An edit to a csrc header renames every library (a stale build is
    never loaded); other files do not."""
    (tmp_path / "k.cu").write_text('#include "hopper.cuh"\nint f() { return 1; }\n')
    (tmp_path / "hopper.cuh").write_text("#pragma once\n")
    first = source_digest("k", tmp_path)
    assert source_digest("k", tmp_path) == first
    (tmp_path / "notes.py").write_text("x = 1\n")
    assert source_digest("k", tmp_path) == first
    (tmp_path / "hopper.cuh").write_text("#pragma once\n// changed\n")
    second = source_digest("k", tmp_path)
    assert second != first
    (tmp_path / "k.cu").write_text('#include "hopper.cuh"\nint f() { return 2; }\n')
    assert source_digest("k", tmp_path) not in (first, second)
