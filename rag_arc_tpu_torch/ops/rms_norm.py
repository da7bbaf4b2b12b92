"""The residual add and RMSNorm of a pre-norm decoder layer, in one pass;
and the gated RMSNorm of a Mamba-2 mixer, in one pass.

Replaces no Pallas kernel: on the TPU, XLA fused the JAX models' chain
``x + delta`` → ``x.astype(f32)`` → mean of squares → rsqrt → ``· w`` →
cast by itself. Eager PyTorch runs that chain as ten launches that write
two f32 copies of the activations and read them again. Both decoder
stacks of the port (``models/qwen3.py``, ``models/lfm2_moe.py``) call
:func:`add_rms_norm` at every norm site: the layer's input norm takes the
previous layer's pending feed-forward output as ``delta``, the
feed-forward's norm takes the mixer's, the final norm the last layer's.

For each row of x (T, H) it computes, with the chain's rounding points:

    x_new = round(x + s · delta)               (the residual stream, as torch's add)
    y = round(x̂ · rsqrt(mean(x̂²) + eps) · w)   (x̂ = f32(x_new), f32 throughout)

``s`` is the residual multiplier (1 for Qwen3 and LFM2, where ``s · delta``
is exact, 0.22 for Granite 4.0-H, ``models/granite_hybrid.py``, whose
product and sum the kernel rounds once where HF rounds each). With s = 1
``x_new`` is bit-equal to torch's ``x + delta``, and ``y`` differs
from the plain chain only by the order of the f32 sum of squares (and the
card's rsqrt against PyTorch's): on the rare element whose f32 value sits
on a rounding boundary, by one step of the output dtype.

It is bound by device memory: it reads x and delta and writes x_new and y
once, 4·T·H·2 bytes in bf16, against ~4 FLOPs an element. On the card
:func:`add_rms_norm` launches one Triton kernel: each program takes one
whole row (block width and warps from H alone, :func:`schedule`), loads
it once, keeps the sum of squares in f32 registers and writes both
outputs once, so nothing but the four tensors crosses device memory. The
row count is only the grid's size, so no new pack size compiles. On the
CPU it runs :func:`add_rms_norm_plain`, the chain itself.

:func:`gated_rms_norm` is the norm that closes a Mamba-2 mixer (HF's
``GraniteMoeHybridRMSNormGated`` with one group): ``w · rms(y · silu(z))``
over all of a token's scan channels (8,192 in Granite 4.0-H), f32 inside,
rounded once. Replaces no TPU kernel (the JAX package has no state-space
model). It is bound by device memory: it reads y and z and writes the
output once, 3·T·C·2 bytes in bf16, against ~8 FLOPs an element. On the
card one Triton launch, one row a program as above (``z`` may be a column
slice of the mixer's input projection: the kernel takes its row stride);
on the CPU :func:`gated_rms_norm_plain`.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rag_arc_tpu_torch.ops._build import count_launch

# kernel launches since the count was last set to 0: ``launches`` the add +
# RMSNorm kernel's, ``launches_gated`` the gated norm's; only the CUDA
# branches add
launches = 0
launches_gated = 0

MAX_HIDDEN = 8192


def add_rms_norm_plain(x: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor,
                       eps: float, scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`add_rms_norm`: the decoder's former
    chain, ``x + delta`` in x's dtype (``x + scale · delta`` in f32,
    rounded once, for a scale other than 1), then the f32 RMSNorm rounded
    once to x's dtype."""
    if delta is not None:
        x = x + delta if scale == 1.0 else (x.float() + scale * delta.float()).to(x.dtype)
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return x, (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def schedule(h: int) -> Tuple[int, int]:
    """(block width, warps) for hidden size ``h``: the block is the power of
    two at or above ``h``, eight 16-bit values a thread."""
    block = 1 << max(0, h - 1).bit_length()
    return block, min(16, max(1, block // 256))


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def add_rms_norm_kernel(x_ptr, d_ptr, w_ptr, xo_ptr, y_ptr, eps, scale, H: tl.constexpr,
                            BLOCK_H: tl.constexpr, HAS_DELTA: tl.constexpr):
        c = tl.arange(0, BLOCK_H)
        m = c < H
        off = tl.program_id(0).to(tl.int64) * H + c
        x = tl.load(x_ptr + off, mask=m, other=0.0)
        if HAS_DELTA:
            d = tl.load(d_ptr + off, mask=m, other=0.0)
            x = (x.to(tl.float32) + scale * d.to(tl.float32)).to(xo_ptr.dtype.element_ty)
            tl.store(xo_ptr + off, x, mask=m)
        xf = x.to(tl.float32)
        rstd = tl.math.rsqrt(tl.sum(xf * xf, axis=0) * (1.0 / H) + eps)
        w = tl.load(w_ptr + c, mask=m, other=0.0).to(tl.float32)
        tl.store(y_ptr + off, (xf * rstd * w).to(y_ptr.dtype.element_ty), mask=m)

    return add_rms_norm_kernel


def add_rms_norm(x: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor,
                 eps: float, scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (..., H) and ``delta`` of its shape and dtype, or None (a norm
    with no add before it); ``weight`` (H,); ``scale`` the residual
    multiplier. Returns ``(x_new, y)``, both of x's shape and dtype:
    ``x_new`` is ``x + scale · delta`` (``x`` itself where ``delta`` is
    None), ``y`` its RMSNorm. CPU tensors take :func:`add_rms_norm_plain`;
    CUDA tensors launch the kernel on the current stream or raise."""
    h = x.shape[-1]
    if delta is not None and (delta.shape != x.shape or delta.dtype != x.dtype):
        raise ValueError(f"delta must match x {tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(delta.shape)} {delta.dtype}")
    if weight.shape != (h,):
        raise ValueError(f"weight must be ({h},), got {tuple(weight.shape)}")
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, delta, weight, eps, scale)
    if weight.device != x.device or (delta is not None and delta.device != x.device):
        raise ValueError("add_rms_norm inputs must share one device")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"add_rms_norm kernel takes bf16 or f32, not {x.dtype}")
    if not 0 < h <= MAX_HIDDEN:
        raise ValueError(f"add_rms_norm kernel takes 1 to {MAX_HIDDEN} columns, got {h}")
    if not (x.is_contiguous() and weight.is_contiguous()
            and (delta is None or delta.is_contiguous())):
        raise ValueError("add_rms_norm kernel needs contiguous tensors")
    if x.device.type != "cuda":
        raise ValueError(f"no add_rms_norm kernel for device {x.device}")
    y = torch.empty_like(x)
    x_new = x if delta is None else torch.empty_like(x)
    n = x.numel() // h
    if n == 0:
        return x_new, y
    block, warps = schedule(h)
    with torch.cuda.device(x.device):
        _kernel()[(n,)](x, x if delta is None else delta, weight, x_new, y, float(eps),
                        float(scale), H=h, BLOCK_H=block, HAS_DELTA=delta is not None,
                        num_warps=warps)
    count_launch(__name__)
    return x_new, y


def gated_rms_norm_plain(y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                         eps: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`gated_rms_norm`, in f32, rounded once."""
    g = y.float() * F.silu(z.float())
    var = torch.mean(g * g, dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + eps) * weight.float()).to(y.dtype)


@functools.lru_cache(maxsize=None)
def _gated_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def gated_rms_norm_kernel(y_ptr, z_ptr, w_ptr, o_ptr, z_stride, eps, C: tl.constexpr,
                              BLOCK_C: tl.constexpr):
        c = tl.arange(0, BLOCK_C)
        m = c < C
        row = tl.program_id(0).to(tl.int64)
        y = tl.load(y_ptr + row * C + c, mask=m, other=0.0).to(tl.float32)
        z = tl.load(z_ptr + row * z_stride + c, mask=m, other=0.0).to(tl.float32)
        g = y * z * tl.sigmoid(z)
        rstd = tl.math.rsqrt(tl.sum(g * g, axis=0) * (1.0 / C) + eps)
        w = tl.load(w_ptr + c, mask=m, other=0.0).to(tl.float32)
        tl.store(o_ptr + row * C + c, (g * rstd * w).to(o_ptr.dtype.element_ty), mask=m)

    return gated_rms_norm_kernel


def gated_rms_norm(y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """``y`` (..., C) the scan's output, contiguous; ``z`` (..., C) the gate
    of the same dtype, whose rows may be strided (a column slice of the
    input projection: the last axis dense, one row stride); ``weight``
    (C,). Returns ``w · rms(y · silu(z))`` of y's shape and dtype. CPU
    tensors take :func:`gated_rms_norm_plain`; CUDA tensors launch the
    kernel on the current stream or raise."""
    c = y.shape[-1]
    if z.shape != y.shape or z.dtype != y.dtype:
        raise ValueError(f"z must match y {tuple(y.shape)} {y.dtype}, got "
                         f"{tuple(z.shape)} {z.dtype}")
    if weight.shape != (c,):
        raise ValueError(f"weight must be ({c},), got {tuple(weight.shape)}")
    if y.device.type == "cpu":
        return gated_rms_norm_plain(y, z, weight, eps)
    if y.device.type != "cuda":
        raise ValueError(f"no gated_rms_norm kernel for device {y.device}")
    if z.device != y.device or weight.device != y.device:
        raise ValueError("gated_rms_norm inputs must share one device")
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gated_rms_norm kernel takes bf16 or f32, not {y.dtype}")
    if not 0 < c <= MAX_HIDDEN:
        raise ValueError(f"gated_rms_norm kernel takes 1 to {MAX_HIDDEN} columns, got {c}")
    if not (y.is_contiguous() and weight.is_contiguous()):
        raise ValueError("gated_rms_norm kernel needs a contiguous y and weight")
    rows = z.reshape(-1, c)  # a view of one row stride where z's layout has one
    if rows.stride(1) != 1:
        rows = rows.contiguous()
    out = torch.empty_like(y)
    n = y.numel() // c
    if n == 0:
        return out
    block, warps = schedule(c)
    with torch.cuda.device(y.device):
        _gated_kernel()[(n,)](y, rows, weight, out, rows.stride(0), float(eps), C=c,
                              BLOCK_C=block, num_warps=warps)
    count_launch(__name__, "launches_gated")
    return out

