"""Int8 sub-tile max producer of the quantized two-level top-k.

Counterpart of the JAX package's int8 producers:
``rag_arc_tpu/ops/two_level.py::_subtile_max_kernel_i8_block`` (block
scales), ``_subtile_max_kernel_i8`` (per-row scales) and the int8 mode of
``two_level_stream.py::_stream_kernel`` (whose role, with its certificate,
the masked block mode takes). On the card it runs the hand-written CUDA
kernel ``csrc/subtile_max_i8.cu`` (int8 × int8 → int32 on the tensor
cores); on the CPU it runs :func:`subtile_max_i8_plain`.

Every step is exact for d ≤ 1040 (|dot| ≤ d·127² < 2²⁴, so raw dots
convert to f32 exactly), so kernel and plain version agree bit for bit.
The result is (B, N/g), the layout of ``ops/subtile_max.py``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rag_arc_tpu_torch.ops._build import Built, build
from rag_arc_tpu_torch.ops.subtile_max import KERNEL_MAX_G, NEG, SUPPORTED_G, widen_g

MASK_I32 = -(1 << 30)  # raw-dot sentinel of a dead row (block mode)

MAX_DIM = 1040  # d·127² < 2²⁴: raw int32 maxima convert to f32 exactly

# rows widened to f32 at a time by the plain version
_PLAIN_ROWS = 1 << 16

# kernel launches since the count was last set to 0; only the wrapper's
# CUDA branch adds to it
launches = 0


def subtile_max_i8_plain(
    q_i8: torch.Tensor,
    codes: torch.Tensor,
    scale: torch.Tensor,
    valid: torch.Tensor,
    g: int,
    block_scales: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version, in f32 on integer values (exact for
    d ≤ 1040). Block mode: the raw max over live rows of each sub-tile
    times the sub-tile's one scale ``scale[t·g]``, NEG for an all-dead
    sub-tile; row mode: the max over live rows of dot × row scale. The
    corpus is widened in row chunks, so no f32 copy of it exists."""
    b, n = q_i8.shape[0], codes.shape[0]
    q32 = q_i8.float()
    out = torch.empty((b, n // g), dtype=torch.float32, device=codes.device)
    for start in range(0, n, _PLAIN_ROWS):
        stop = min(start + _PLAIN_ROWS, n)
        raw = q32 @ codes[start:stop].float().T
        live = valid[None, start:stop].bool()
        if block_scales:
            raw = torch.where(live, raw, float(MASK_I32))
            m = raw.reshape(b, -1, g).amax(dim=2)
            sub = torch.where(m <= MASK_I32 * 0.5, NEG, m * scale[start:stop:g])
        else:
            scored = torch.where(live, raw * scale[None, start:stop], NEG)
            sub = scored.reshape(b, -1, g).amax(dim=2)
        out[:, start // g : stop // g] = sub
    return out


@functools.lru_cache(maxsize=None)
def load() -> Built:
    """Build (once) and bind the CUDA kernel library."""
    built = build("subtile_max_i8")
    fn = built.lib.subtile_max_i8_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return built


def _check(q_i8, codes, scale, valid, g) -> None:
    if q_i8.ndim != 2 or codes.ndim != 2 or q_i8.shape[1] != codes.shape[1]:
        raise ValueError(
            f"expected query codes (B, d) and corpus codes (N, d), got "
            f"{tuple(q_i8.shape)} and {tuple(codes.shape)}"
        )
    if q_i8.dtype != torch.int8 or codes.dtype != torch.int8:
        raise ValueError(f"codes must be int8, got {q_i8.dtype} and {codes.dtype}")
    n, d = codes.shape
    if d > MAX_DIM:
        raise ValueError(
            f"dim {d} > {MAX_DIM}: raw int32 maxima would not convert to f32 exactly"
        )
    if scale.shape != (n,) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be ({n},) float32")
    if valid.shape != (n,) or valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"valid must be ({n},) bool or uint8")
    if g not in SUPPORTED_G:
        raise ValueError(f"g must be one of {SUPPORTED_G}, got {g}")
    if n % g:
        raise ValueError(f"corpus rows {n} not a multiple of g {g}")


def subtile_max_i8(
    q_i8: torch.Tensor,
    codes: torch.Tensor,
    scale: torch.Tensor,
    valid: torch.Tensor,
    g: int = 16,
    block_scales: bool = True,
) -> torch.Tensor:
    """(B, N/g) f32 sub-tile maxima of the int8 metric: query codes
    ``q_i8`` (B, d) int8 (``quantize_queries``), corpus ``codes`` (N, d)
    int8, per-row ``scale`` (N,) f32, row mask ``valid`` (N,).

    ``block_scales=True`` asserts that every g-row sub-tile shares one
    scale. CPU tensors take :func:`subtile_max_i8_plain`; CUDA tensors
    launch the kernel on the current stream or raise (g = 256 from the
    g = 128 kernel and a pairwise max, as in ``subtile_max``)."""
    global launches
    _check(q_i8, codes, scale, valid, g)
    if codes.device.type == "cpu":
        return subtile_max_i8_plain(q_i8, codes, scale, valid, g, block_scales)
    if codes.device.type != "cuda":
        raise ValueError(f"no subtile_max_i8 kernel for device {codes.device}")
    tensors = (q_i8, codes, scale, valid)
    if any(t.device != codes.device for t in tensors):
        raise ValueError("query codes, corpus codes, scale and valid must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("subtile_max_i8 kernel needs contiguous tensors")
    b, d = q_i8.shape
    n = codes.shape[0]
    if n >= 2**31 or b * d >= 2**31:
        raise ValueError("subtile_max_i8 kernel indexes rows with 32-bit ints")
    kg = min(g, KERNEL_MAX_G)
    out = torch.empty((b, n // kg), dtype=torch.float32, device=codes.device)
    if b == 0 or n == 0:
        return widen_g(out, g, kg)
    fn = load().lib.subtile_max_i8_launch
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q_i8.data_ptr(), codes.data_ptr(), scale.data_ptr(),
            valid.view(torch.uint8).data_ptr(), out.data_ptr(),
            b, n, d, kg, int(block_scales), stream,
        )
    if err != 0:
        raise RuntimeError(f"subtile_max_i8 kernel launch failed: CUDA error {err}")
    launches += 1
    return widen_g(out, g, kg)
