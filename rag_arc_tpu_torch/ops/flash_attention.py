"""Causal, segment-masked attention forward.

Counterpart of the library flash attention that
``rag_arc_tpu/models/qwen3.py`` calls on the TPU
(``jax.experimental.pallas.ops.tpu.flash_attention`` with
``SegmentIds(q=seg, kv=seg)``, ``causal=True``). On the card
:func:`flash_attention` runs the hand-written CUDA kernel
``csrc/flash_attention.cu``, which never writes the (B, H, L, L) scores;
on the CPU it runs :func:`attention_plain`.

Semantics: query i attends key j iff ``seg[i] == seg[j]`` and, when
causal, ``j <= i``. K and V may carry fewer heads than Q (grouped-query
attention): with HKV dividing H, query head h reads KV head
``h // (H // HKV)``; HKV == H is the JAX library's own contract. The
reranker passes the mask as int (pad 0, live 1), so a live row attends
the live keys up to it and a pad row attends only pads. No row attends
an empty set under the causal rule (it always sees itself), so every
row comes out finite.

Rounding points, which the kernel follows: scores and the softmax in f32;
the unnormalized probabilities ``exp(s - max)`` are rounded to the value
dtype before P·V, which accumulates in f32; the row sum is taken over the
f32 probabilities; the output is ``acc / sum`` in q's dtype.

``out=`` takes a (B, H, L, D) tensor whose last axis is dense and which
may be a strided view (``buf.transpose(1, 2)`` of a (B, L, H, D) buffer):
the result is written through its strides and the tensor returned, so the
model's o_proj reads the buffer with no copy.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from rag_arc_tpu_torch.ops._build import Built, build, count_launch

SUPPORTED_D = (64, 128)

# kernel launches since the count was last set to 0; only the wrapper's
# CUDA branch adds to it
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,
    *,
    causal: bool,
    sm_scale: float,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version: q (B, H, L, D), k/v (B, HKV, L, D) with HKV
    dividing H, segment_ids (B, L) int → (B, H, L, D) in q's dtype, written
    into ``out`` when given. Materializes the (B, H, L, L) scores."""
    l = q.shape[2]
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    s = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    allowed = segment_ids[:, :, None] == segment_ids[:, None, :]  # (B, L, L)
    if causal:
        allowed = allowed & torch.ones(l, l, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~allowed[:, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    # a row with no allowed key (only possible without the causal rule)
    # keeps m = -inf: take 0 there so exp gives 0, not NaN
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    acc = p.to(v.dtype).float() @ v.float()
    res = (acc / torch.where(denom > 0, denom, torch.ones_like(denom))).to(q.dtype)
    if out is None:
        return res
    out.copy_(res)
    return out


@functools.lru_cache(maxsize=None)
def load() -> Built:
    """Build (once) and bind the CUDA kernel library."""
    built = build("flash_attention")
    fn = built.lib.flash_attention_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
        ctypes.c_void_p, ctypes.c_void_p,                   # segment ids, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H HKV L D
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # out strides
        ctypes.c_float, ctypes.c_int, ctypes.c_int,              # scale, causal, dtype
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return built


def _check_out(out: torch.Tensor, q: torch.Tensor) -> None:
    if out.shape != q.shape or out.dtype != q.dtype or out.device != q.device:
        raise ValueError(
            f"out must be {tuple(q.shape)} {q.dtype} on {q.device}, got "
            f"{tuple(out.shape)} {out.dtype} on {out.device}"
        )
    if out.stride(-1) != 1:
        raise ValueError("out must have a dense last axis")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q (B, H, L, D), k/v (B, HKV, L, D) of one dtype with HKV dividing H
    (query head h reads KV head h // (H // HKV)); segment_ids (B, L) int32
    (for the reranker the mask as int: pad 0, live 1); ``sm_scale``
    defaults to 1/sqrt(D). Returns (B, H, L, D) in q's dtype: ``out``
    when given (any strides, last axis dense), written in place.

    CPU tensors take :func:`attention_plain`; CUDA tensors launch the
    kernel on the current stream or raise. A contiguous bf16 q, k or v
    whose data is off a 16-byte boundary (a view with a storage offset) is
    copied first: the kernel's TMA loads need aligned bases."""
    if (q.ndim != 4 or k.ndim != 4 or v.shape != k.shape or k.shape[0] != q.shape[0]
            or k.shape[2:] != q.shape[2:] or k.shape[1] == 0 or q.shape[1] % k.shape[1]):
        raise ValueError(
            f"expected q (B, H, L, D) and k, v (B, HKV, L, D) with HKV dividing H, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, l, d = q.shape
    hkv = k.shape[1]
    if segment_ids.shape != (b, l):
        raise ValueError(f"segment_ids must be ({b}, {l}), got {tuple(segment_ids.shape)}")
    if out is not None:
        _check_out(out, q)
    scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, segment_ids, causal=causal, sm_scale=scale, out=out)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    if any(t.device != q.device for t in (k, v, segment_ids)):
        raise ValueError("flash_attention inputs must share one device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention kernel takes q, k, v all bf16 or all f32, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if d not in SUPPORTED_D:
        raise ValueError(f"flash_attention kernel takes head dim in {SUPPORTED_D}, got {d}")
    if segment_ids.dtype != torch.int32:
        raise ValueError(f"segment_ids must be int32, not {segment_ids.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, segment_ids)):
        raise ValueError("flash_attention kernel needs contiguous tensors")
    if out is None:
        out = torch.empty_like(q)
    elif q.dtype == torch.bfloat16 and (
            out.data_ptr() % 4 or any(st % 2 for st in out.stride()[:3])):
        raise ValueError("out must allow 4-byte bf16 pair stores (even strides, aligned)")
    if q.numel() == 0:
        return out
    if q.dtype == torch.bfloat16:
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    fn = load().lib.flash_attention_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(),
            out.data_ptr(), b, h, hkv, l, d, out.stride(0), out.stride(1), out.stride(2),
            scale, int(causal), _DTYPE_CODE[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    count_launch(__name__)
    return out
