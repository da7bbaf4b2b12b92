"""Causal, segment-masked attention forward.

Counterpart of the library flash attention that
``rag_arc_tpu/models/qwen3.py`` calls on the TPU
(``jax.experimental.pallas.ops.tpu.flash_attention`` with
``SegmentIds(q=seg, kv=seg)``, ``causal=True``). On the card
:func:`flash_attention` runs the hand-written CUDA kernel
``csrc/flash_attention.cu``, which never writes the (B, H, L, L) scores;
on the CPU it runs :func:`attention_plain`.

Semantics: query i attends key j iff ``seg[i] == seg[j]`` and, when
causal, ``j <= i``. The reranker passes the mask as int (pad 0, live 1),
so a live row attends the live keys up to it and a pad row attends only
pads. No row attends an empty set under the causal rule (it always sees
itself), so every row comes out finite.

Rounding points, which the kernel follows: scores and the softmax in f32;
the unnormalized probabilities ``exp(s - max)`` are rounded to the value
dtype before P·V, which accumulates in f32; the row sum is taken over the
f32 probabilities; the output is ``acc / sum`` in q's dtype.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from rag_arc_tpu_torch.ops._build import Built, build

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
) -> torch.Tensor:
    """Plain PyTorch version: q, k, v (B, H, L, D), segment_ids (B, L) int
    → (B, H, L, D) in q's dtype. Materializes the (B, H, L, L) scores."""
    l = q.shape[2]
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
    out = acc / torch.where(denom > 0, denom, torch.ones_like(denom))
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def load() -> Built:
    """Build (once) and bind the CUDA kernel library."""
    built = build("flash_attention")
    fn = built.lib.flash_attention_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
        ctypes.c_void_p, ctypes.c_void_p,                   # segment ids, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, L, D
        ctypes.c_float, ctypes.c_int, ctypes.c_int,              # scale, causal, dtype
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return built


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """q, k, v (B, H, L, D) of one dtype; segment_ids (B, L) int32 (for
    the reranker the mask as int: pad 0, live 1); ``sm_scale`` defaults
    to 1/sqrt(D). Returns (B, H, L, D) in q's dtype.

    CPU tensors take :func:`attention_plain`; CUDA tensors launch the
    kernel on the current stream or raise."""
    global launches
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"expected q, k, v of one (B, H, L, D) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, l, d = q.shape
    if segment_ids.shape != (b, l):
        raise ValueError(f"segment_ids must be ({b}, {l}), got {tuple(segment_ids.shape)}")
    scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, segment_ids, causal=causal, sm_scale=scale)
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
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = load().lib.flash_attention_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(),
            out.data_ptr(), b, h, l, d, scale, int(causal), _DTYPE_CODE[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out
