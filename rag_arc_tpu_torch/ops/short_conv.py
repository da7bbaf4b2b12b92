"""The gated short convolution of an LFM2 conv block, segment-aware.

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

On the card :func:`short_conv` launches one Triton kernel: each program
takes a block of tokens by a block of channels, reads B, C and x of the
token and B, x of its K − 1 predecessors (neighbouring programs' rows come
from L2), keeps ``B * x``, the sum and the gate in f32 registers and writes
``y`` once, rounded to the input dtype. It is bound by device memory: it
reads 3H and writes H values a token, ~1 FLOP a byte, so its bound is
(3H + H) · 2 bytes a token at 3.35 TB/s. On the CPU it runs
:func:`short_conv_plain`, the same arithmetic in f32.
"""

from __future__ import annotations

import functools

import torch

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


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit(do_not_specialize=["n_tok", "row_len"])
    def short_conv_kernel(bcx_ptr, w_ptr, seg_ptr, y_ptr, n_tok, row_len,
                          H: tl.constexpr, K: tl.constexpr,
                          BLOCK_T: tl.constexpr, BLOCK_H: tl.constexpr):
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
            row = bcx_ptr + src[:, None] * (3 * H) + ch[None, :]
            b = tl.load(row, mask=m, other=0.0).to(tl.float32)
            x = tl.load(row + 2 * H, mask=m, other=0.0).to(tl.float32)
            w = tl.load(w_ptr + ch * K + j, mask=ch_ok, other=0.0).to(tl.float32)
            acc += b * x * w[None, :]
        m = t_ok[:, None] & ch_ok[None, :]
        c = tl.load(bcx_ptr + t64[:, None] * (3 * H) + H + ch[None, :], mask=m,
                    other=0.0).to(tl.float32)
        y = tl.where(live[:, None], c * acc, 0.0)
        tl.store(y_ptr + t64[:, None] * H + ch[None, :], y.to(y_ptr.dtype.element_ty), mask=m)

    return triton, short_conv_kernel


def short_conv(bcx: torch.Tensor, weight: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """``bcx`` (R, L, 3H), the ``in_proj`` output ``[B | C | x]``; ``weight``
    (H, K), HF's ``conv.weight`` without its middle axis; ``seg`` (R, L)
    int32 segment ids, −1 on padding. Returns ``y`` (R, L, H) in ``bcx``'s
    dtype. CPU tensors take :func:`short_conv_plain`; CUDA tensors launch
    the kernel on the current stream or raise."""
    r, l, h, k = _check(bcx, weight, seg)
    if bcx.device.type == "cpu":
        return short_conv_plain(bcx, weight, seg)
    if bcx.device.type != "cuda":
        raise ValueError(f"no short_conv kernel for device {bcx.device}")
    if weight.device != bcx.device or seg.device != bcx.device:
        raise ValueError("short_conv inputs must share one device")
    if bcx.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"short_conv kernel takes bf16 or f32, not {bcx.dtype}")
    if seg.dtype != torch.int32:
        raise ValueError(f"seg must be int32, not {seg.dtype}")
    if not (bcx.is_contiguous() and weight.is_contiguous() and seg.is_contiguous()):
        raise ValueError("short_conv kernel needs contiguous tensors")
    y = torch.empty((r, l, h), dtype=bcx.dtype, device=bcx.device)
    n = r * l
    if n == 0:
        return y
    triton, kernel = _kernel()
    grid = (triton.cdiv(n, BLOCK_T), triton.cdiv(h, BLOCK_H))
    with torch.cuda.device(bcx.device):
        kernel[grid](bcx, weight, seg, y, n, l, H=h, K=k, BLOCK_T=BLOCK_T, BLOCK_H=BLOCK_H,
                     num_warps=4)
    count_launch(__name__)
    return y
