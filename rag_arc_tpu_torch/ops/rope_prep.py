"""Fused attention prep: per-head qk-RMSNorm + RoPE + (B,L,H·D)→(B,H,L,D)
+ GQA repeat of K/V (optional).

Counterpart of ``rag_arc_tpu/ops/rope_prep.py``. On the card
:func:`rope_prep` runs the hand-written CUDA kernel ``csrc/rope_prep.cu``
(one HBM pass per tensor); on the CPU it runs :func:`rope_prep_plain`,
the counterpart of ``rope_prep_ref`` in plain PyTorch.

The rotation uses the roll / sign-fold form of the HF half-split rope:
with ``cos_full = [cos a, cos a]`` and ``sin_signed = [-sin a, sin a]``
(:func:`rope_cos_sin`, computed once per forward),

    rope(x) = x * cos_full + roll(x, D/2) * sin_signed.

The norm and the rotation run in f32 and round once, to the input dtype.

``repeat_kv=True`` (the default) keeps the JAX contract: K and V come back
with NH heads, each KV head repeated for its query-head group.
``repeat_kv=False`` returns them with their NKV heads, each written once:
the model's path, whose flash attention reads the KV heads directly.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from rag_arc_tpu_torch.ops._build import Built, build, count_launch

SUPPORTED_D = (64, 128)

# kernel launches since the count was last set to 0; only the wrapper's
# CUDA branch adds to it
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rope_cos_sin(positions: torch.Tensor, theta: float, d: int):
    """Per-forward rope tables: positions (B, L) int → ``cos_full``,
    ``sin_signed``, both (B, L, D) f32."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=positions.device) / d)
    )
    ang = positions[:, :, None].float() * inv_freq[None, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def rope_prep_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    qs: Optional[torch.Tensor] = None,
    ks: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
    repeat_kv: bool = True,
):
    """Plain PyTorch version. q (B, L, NH, D), k/v (B, L, NKV, D); cos/sin
    (B, L, D) f32; qs/ks optional (D,) RMS-norm scales. Returns (B, NH, L,
    D) q and (B, NH or, without ``repeat_kv``, NKV, L, D) k, v in q's
    dtype."""
    d = q.shape[-1]

    def norm(x, s):
        x32 = x.float()
        if s is None:
            return x32
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        return x32 * torch.rsqrt(var + eps) * s.float()

    def one(x, s):
        xt = norm(x, s).transpose(1, 2)  # (B, H, L, D) f32
        r = xt * cos[:, None] + torch.roll(xt, d // 2, dims=-1) * sin[:, None]
        return r.to(q.dtype).contiguous()

    kr, vr = one(k, ks), v.transpose(1, 2)
    if repeat_kv:
        group = q.shape[2] // k.shape[2]
        kr = kr.repeat_interleave(group, dim=1)
        vr = vr.repeat_interleave(group, dim=1)
    return one(q, qs), kr, vr.contiguous()


@functools.lru_cache(maxsize=None)
def load() -> Built:
    """Build (once) and bind the CUDA kernel library."""
    built = build("rope_prep")
    fn = built.lib.rope_prep_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
        ctypes.c_void_p, ctypes.c_void_p,                   # cos, sin
        ctypes.c_void_p, ctypes.c_void_p,                   # qs, ks
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # qo, ko, vo
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # row strides
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # eps, vec, repeat, dtype
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return built


def _rows_contiguous(x: torch.Tensor) -> bool:
    """(B, L, W) with its last axis dense and its (b, l) rows evenly
    strided: a contiguous tensor, or a column slice of one (the q/k/v
    slices of a fused qkv projection)."""
    return x.stride(2) == 1 and x.stride(0) == x.shape[1] * x.stride(1)


def _aligned(x: torch.Tensor, per_lane: int) -> bool:
    """True when every row start of x is aligned for one vector load of
    ``per_lane`` elements."""
    nbytes = per_lane * x.element_size()
    return x.data_ptr() % nbytes == 0 and x.stride(1) % per_lane == 0


def rope_prep(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    qs: Optional[torch.Tensor] = None,
    ks: Optional[torch.Tensor] = None,
    *,
    nh: int,
    nkv: int,
    d: int,
    eps: float = 1e-6,
    repeat_kv: bool = True,
):
    """q (B, L, NH·D), k/v (B, L, NKV·D) in the projection layout; cos/sin
    (B, L, D) f32 from :func:`rope_cos_sin`; qs/ks optional (D,) per-head
    RMS-norm scales (both or neither). Returns the normed, roped and
    transposed (B, NH, L, D) q and k, v in q's dtype: GQA-repeated to
    (B, NH, L, D) with ``repeat_kv``, else (B, NKV, L, D).

    CPU tensors take :func:`rope_prep_plain`; CUDA tensors launch the
    kernel on the current stream or raise."""
    b, l, _ = q.shape
    if nh % nkv:
        raise ValueError(f"nh {nh} not a multiple of nkv {nkv}")
    if q.shape != (b, l, nh * d) or k.shape != (b, l, nkv * d) or v.shape != k.shape:
        raise ValueError(
            f"expected q (B, L, {nh * d}) and k/v (B, L, {nkv * d}), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if cos.shape != (b, l, d) or sin.shape != (b, l, d):
        raise ValueError(f"cos/sin must be ({b}, {l}, {d})")
    if (qs is None) != (ks is None):
        raise ValueError("qs and ks are given together or not at all")
    if q.device.type == "cpu":
        return rope_prep_plain(
            q.reshape(b, l, nh, d), k.reshape(b, l, nkv, d), v.reshape(b, l, nkv, d),
            cos, sin, qs, ks, eps, repeat_kv,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no rope_prep kernel for device {q.device}")
    tensors = [q, k, v, cos, sin] + ([qs, ks] if qs is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("rope_prep inputs must share one device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"rope_prep kernel takes q, k, v all f32 or all bf16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if d not in SUPPORTED_D:
        raise ValueError(f"rope_prep kernel takes head dim in {SUPPORTED_D}, got {d}")
    if any(t.dtype != torch.float32 for t in tensors[3:]):
        raise ValueError("cos, sin, qs and ks must be float32")
    if not all(_rows_contiguous(t) for t in (q, k, v)):
        raise ValueError("rope_prep kernel needs q, k, v with contiguous rows")
    if not all(t.is_contiguous() for t in tensors[3:]):
        raise ValueError("rope_prep kernel needs contiguous cos, sin, qs, ks")
    kv_heads = nh if repeat_kv else nkv
    out = [torch.empty((b, h, l, d), dtype=q.dtype, device=q.device)
           for h in (nh, kv_heads, kv_heads)]
    if b == 0 or l == 0:
        return tuple(out)
    per_lane = d // 32
    vec = int(all(_aligned(t, per_lane) for t in (q, k, v, cos, sin)))
    fn = load().lib.rope_prep_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            None if qs is None else qs.data_ptr(), None if ks is None else ks.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            q.stride(1), k.stride(1), v.stride(1),
            b, l, nh, nkv, d, float(eps), vec, int(repeat_kv), _DTYPE_CODE[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"rope_prep kernel launch failed: CUDA error {err}")
    count_launch(__name__)
    return tuple(out)
