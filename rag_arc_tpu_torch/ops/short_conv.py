"""The short causal convolutions of the hybrid decoders, segment-aware: the
gated form of an LFM2 conv block and the Mamba-2 form of a Granite 4.0-H
mixer, one kernel body.

Replaces no TPU kernel: the JAX package has no LFM2 model. It was added
for ``models/lfm2_moe.py``, whose conv layers read the ``in_proj`` output
``[B | C | x]`` (..., 3H) and compute, channel by channel,

    y[t] = C[t] * sum_j w[:, j] * (B * x)[t - (K - 1) + j]

(HF's ``Lfm2ShortConv``: a depthwise causal ``Conv1d`` of width K over
``B * x``, gated by ``C``). A tap that reaches before the row's start, into
another segment (``seg`` differs from the token's) or into padding (``seg``
−1) reads zero, so sequences packed several to a row (``models/packing.py``)
never read each other, and a left-padded row's pads read as HF's
``apply_mask_to_padding_states`` makes them. A padding token's own output
is zero.

The Mamba-2 form (:func:`mamba_conv`, added for
``models/granite_hybrid.py``; HF's ``GraniteMoeHybridMambaLayer`` conv1d)
is ungated, with a bias and a SiLU, over the C = d_inner + 2·d_state
channels ``[x | B | C]`` of the mixer's input projection:

    y[t] = silu(bias + sum_j w[:, j] * v[t - (K - 1) + j])

with the same reads of zero before a row's start, across a segment start
and from padding, and a padding token's own output zero (HF zeroes the
pads' input and output, ``apply_mask_to_padding_states``; the packed rows
are HF's ``seq_idx``).

On the card :func:`short_conv` and :func:`mamba_conv` launch one Triton
kernel, its form a compile-time switch: each program takes a block of
tokens by a block of channels, reads the token's inputs and its K − 1
predecessors' (neighbouring programs' rows come from L2), keeps the
products, the sum and the gate in f32 registers and writes ``y`` once,
rounded to the input dtype. It is bound by device memory: the gated form
reads 3H and writes H values a token, the Mamba form reads and writes C,
~1 FLOP a byte, so its bound is those bytes at 3.35 TB/s. The Mamba form
reads its input through the projection's row stride (a column slice, no
copy) and writes a dense (R, L, C). On the CPU they run
:func:`short_conv_plain` and :func:`mamba_conv_plain`, the same arithmetic
in f32.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from rag_arc_tpu_torch.ops._build import count_launch

# kernel launches since the count was last set to 0; only the CUDA branch adds
launches = 0

BLOCK_T = 32
BLOCK_H = 128


def _check(bcx: torch.Tensor, weight: torch.Tensor, seg: torch.Tensor) -> tuple:
    if bcx.ndim != 3 or bcx.shape[-1] % 3:
        raise ValueError(f"bcx must be (R, L, 3H), got {tuple(bcx.shape)}")
    r, l, h3 = bcx.shape
    h = h3 // 3
    if weight.ndim != 2 or weight.shape[0] != h:
        raise ValueError(f"weight must be ({h}, K), got {tuple(weight.shape)}")
    if seg.shape != (r, l):
        raise ValueError(f"seg must be ({r}, {l}), got {tuple(seg.shape)}")
    return r, l, h, weight.shape[1]


def _same_segment(seg: torch.Tensor, d: int) -> torch.Tensor:
    """(R, L) bool: the token d places back lies in the token's own live
    segment."""
    if d == 0:
        return seg >= 0
    back = torch.full_like(seg, -2)
    back[:, d:] = seg[:, :-d]
    return (seg >= 0) & (back == seg)


def short_conv_plain(bcx: torch.Tensor, weight: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`short_conv`, in f32, rounded once."""
    r, l, h, k = _check(bcx, weight, seg)
    b, c, x = bcx.float().split(h, dim=-1)
    bx = b * x
    w = weight.float()
    acc = torch.zeros_like(bx)
    for j in range(k):
        d = k - 1 - j
        shifted = torch.zeros_like(bx)
        shifted[:, d:] = bx[:, : l - d]
        acc += torch.where(_same_segment(seg, d)[..., None], shifted, 0.0) * w[:, j]
    return (c * acc).to(bcx.dtype)


def mamba_conv_plain(xbc: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                     seg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`mamba_conv`, in f32, rounded once."""
    r, l, c, k = _check_mamba(xbc, weight, bias, seg)
    v = xbc.float()
    w = weight.float()
    acc = torch.zeros_like(v)
    for j in range(k):
        d = k - 1 - j
        shifted = torch.zeros_like(v)
        shifted[:, d:] = v[:, : l - d]
        acc += torch.where(_same_segment(seg, d)[..., None], shifted, 0.0) * w[:, j]
    if bias is not None:
        acc += bias.float()
    return torch.where((seg >= 0)[..., None], F.silu(acc), 0.0).to(xbc.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit(do_not_specialize=["n_tok", "row_len"])
    def short_conv_kernel(src_ptr, w_ptr, b_ptr, seg_ptr, y_ptr, n_tok, row_len,
                          H: tl.constexpr, K: tl.constexpr, S: tl.constexpr,
                          GATED: tl.constexpr, HAS_BIAS: tl.constexpr,
                          BLOCK_T: tl.constexpr, BLOCK_H: tl.constexpr):
        # H output channels; S the input's token stride; the gated form reads
        # [B | C | x] (S = 3H), the Mamba form v (S the projection's width)
        t = tl.program_id(0) * BLOCK_T + tl.arange(0, BLOCK_T)
        ch = tl.program_id(1) * BLOCK_H + tl.arange(0, BLOCK_H)
        t_ok = t < n_tok
        ch_ok = ch < H
        t64 = t.to(tl.int64)
        col = t % row_len
        seg = tl.load(seg_ptr + t64, mask=t_ok, other=-1)
        live = seg >= 0
        acc = tl.zeros((BLOCK_T, BLOCK_H), dtype=tl.float32)
        for j in tl.static_range(K):
            d = K - 1 - j
            src = t64 - d
            ok = t_ok & live & (col >= d)
            if d > 0:
                seg_src = tl.load(seg_ptr + src, mask=ok, other=-2)
                ok = ok & (seg_src == seg)
            m = ok[:, None] & ch_ok[None, :]
            row = src_ptr + src[:, None] * S + ch[None, :]
            w = tl.load(w_ptr + ch * K + j, mask=ch_ok, other=0.0).to(tl.float32)
            if GATED:
                b = tl.load(row, mask=m, other=0.0).to(tl.float32)
                x = tl.load(row + 2 * H, mask=m, other=0.0).to(tl.float32)
                acc += b * x * w[None, :]
            else:
                v = tl.load(row, mask=m, other=0.0).to(tl.float32)
                acc += v * w[None, :]
        m = t_ok[:, None] & ch_ok[None, :]
        if GATED:
            c = tl.load(src_ptr + t64[:, None] * S + H + ch[None, :], mask=m,
                        other=0.0).to(tl.float32)
            y = c * acc
        else:
            if HAS_BIAS:
                acc += tl.load(b_ptr + ch, mask=ch_ok, other=0.0).to(tl.float32)[None, :]
            y = acc * tl.sigmoid(acc)
        y = tl.where(live[:, None], y, 0.0)
        tl.store(y_ptr + t64[:, None] * H + ch[None, :], y.to(y_ptr.dtype.element_ty), mask=m)

    return triton, short_conv_kernel


def _launch(src, weight, bias, seg, y, stride: int, gated: bool) -> None:
    r, l, h = y.shape
    n = r * l
    if n == 0:
        return
    triton, kernel = _kernel()
    grid = (triton.cdiv(n, BLOCK_T), triton.cdiv(h, BLOCK_H))
    with torch.cuda.device(y.device):
        kernel[grid](src, weight, weight if bias is None else bias, seg, y, n, l, H=h,
                     K=weight.shape[1], S=stride, GATED=gated, HAS_BIAS=bias is not None,
                     BLOCK_T=BLOCK_T, BLOCK_H=BLOCK_H, num_warps=4)
    count_launch(__name__)


def _check_device(x, tensors, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {x.device}")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{what} inputs must share one device")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} kernel takes bf16 or f32, not {x.dtype}")
    if tensors[-1].dtype != torch.int32:
        raise ValueError(f"seg must be int32, not {tensors[-1].dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} kernel needs contiguous weights and segment ids")


def short_conv(bcx: torch.Tensor, weight: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """``bcx`` (R, L, 3H), the ``in_proj`` output ``[B | C | x]``; ``weight``
    (H, K), HF's ``conv.weight`` without its middle axis; ``seg`` (R, L)
    int32 segment ids, −1 on padding. Returns ``y`` (R, L, H) in ``bcx``'s
    dtype. CPU tensors take :func:`short_conv_plain`; CUDA tensors launch
    the kernel on the current stream or raise."""
    r, l, h, k = _check(bcx, weight, seg)
    if bcx.device.type == "cpu":
        return short_conv_plain(bcx, weight, seg)
    _check_device(bcx, (weight, seg), "short_conv")
    if not bcx.is_contiguous():
        raise ValueError("short_conv kernel needs contiguous tensors")
    y = torch.empty((r, l, h), dtype=bcx.dtype, device=bcx.device)
    _launch(bcx, weight, None, seg, y, 3 * h, gated=True)
    return y


def _check_mamba(xbc, weight, bias, seg) -> tuple:
    if xbc.ndim != 3:
        raise ValueError(f"xbc must be (R, L, C), got {tuple(xbc.shape)}")
    r, l, c = xbc.shape
    if weight.ndim != 2 or weight.shape[0] != c:
        raise ValueError(f"weight must be ({c}, K), got {tuple(weight.shape)}")
    if bias is not None and bias.shape != (c,):
        raise ValueError(f"bias must be ({c},), got {tuple(bias.shape)}")
    if seg.shape != (r, l):
        raise ValueError(f"seg must be ({r}, {l}), got {tuple(seg.shape)}")
    return r, l, c, weight.shape[1]


def mamba_conv(xbc: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               seg: torch.Tensor) -> torch.Tensor:
    """``xbc`` (R, L, C), the ``[x | B | C]`` columns of a Mamba-2 mixer's
    input projection: a view whose last axis is dense and whose tokens lie
    one row stride apart (a column slice of the (R, L, width) projection);
    ``weight`` (C, K), HF's ``conv1d.weight`` without its middle axis;
    ``bias`` (C,) or None; ``seg`` (R, L) int32 segment ids, −1 on padding.
    Returns ``silu(conv(xbc) + bias)`` (R, L, C), contiguous, in xbc's
    dtype, zero on padding. CPU tensors take :func:`mamba_conv_plain`; CUDA
    tensors launch the kernel on the current stream or raise."""
    r, l, c, _ = _check_mamba(xbc, weight, bias, seg)
    if xbc.device.type == "cpu":
        return mamba_conv_plain(xbc, weight, bias, seg)
    _check_device(xbc, (weight,) + ((bias,) if bias is not None else ()) + (seg,),
                  "mamba_conv")
    stride = xbc.stride(1)
    if xbc.stride(2) != 1 or (r > 1 and xbc.stride(0) != l * stride):
        raise ValueError("mamba_conv kernel needs a dense last axis and one token stride")
    y = torch.empty((r, l, c), dtype=xbc.dtype, device=xbc.device)
    _launch(xbc, weight, bias, seg, y, stride, gated=False)
    return y
