"""Pipelined sub-tile max producer (``producer="stream_piped"``).

Counterpart of ``rag_arc_tpu/ops/two_level_stream.py:53`` ``_stream_kernel_piped``
(``subtile_max_stream(pipelined=True)``): the TPU kernel that issues tile
i's matmul before it reduces tile i-1's score slab, so the MXU and the VPU
overlap. On the card it runs the hand-written CUDA kernel
``csrc/subtile_max_piped.cu`` (bf16 and int8: two consumer warpgroups in
ping-pong on ``wgmma``, one issuing a tile's products while the other
reduces the tile before, fed by a TMA ring; f32 on CUDA cores; the source
says what overlaps with what); on the CPU it runs the plain version.

It computes the function of the port's other producers, masked like them:
bf16/f32 corpora give ``ops/subtile_max.py``'s (B, N/g) maxima (plain
version :func:`subtile_max_plain`), int8 corpora the block mode of
``ops/subtile_max_i8.py`` (plain version :func:`subtile_max_i8_plain`), the
role PR 2 gave the stream kernel's int8 mode. The TPU kernel is maskless;
with dead rows zeroed the two agree wherever a sub-tile holds a live row
with a non-negative score.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from rag_arc_tpu_torch.ops._build import Built, build, count_launch
from rag_arc_tpu_torch.ops.subtile_max import (
    SUPPORTED_G,
    subtile_max_plain,
    tma_operands,
    widen_g,
)
from rag_arc_tpu_torch.ops.subtile_max_i8 import MAX_DIM, subtile_max_i8_plain

# rows a kernel tile reduces: a wider g is served from g = 64 maxima
KERNEL_MAX_G = 64

# kernel launches since the count was last set to 0; only the wrapper's
# CUDA branch adds to it
launches = 0

_MODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def subtile_max_piped_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid: torch.Tensor,
    g: int,
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version: the other producers' plain versions."""
    if corpus.dtype == torch.int8:
        return subtile_max_i8_plain(queries, corpus, scale, valid, g, block_scales=True)
    return subtile_max_plain(queries, corpus, valid, g)


@functools.lru_cache(maxsize=None)
def load() -> Built:
    """Build (once) and bind the CUDA kernel library."""
    built = build("subtile_max_piped")
    fn = built.lib.subtile_max_piped_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return built


def _check(queries, corpus, valid, g, scale) -> None:
    if queries.ndim != 2 or corpus.ndim != 2 or queries.shape[1] != corpus.shape[1]:
        raise ValueError(
            f"expected queries (B, d) and corpus (N, d), got "
            f"{tuple(queries.shape)} and {tuple(corpus.shape)}"
        )
    n, d = corpus.shape
    if corpus.dtype not in _MODE or queries.dtype != corpus.dtype:
        raise ValueError(
            f"queries and corpus must share one of float32, bfloat16, int8; got "
            f"{queries.dtype} and {corpus.dtype}"
        )
    if valid.shape != (n,) or valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"valid must be ({n},) bool or uint8")
    if g not in SUPPORTED_G:
        raise ValueError(f"g must be one of {SUPPORTED_G}, got {g}")
    if n % g:
        raise ValueError(f"corpus rows {n} not a multiple of g {g}")
    if corpus.dtype == torch.int8:
        if scale is None or scale.shape != (n,) or scale.dtype != torch.float32:
            raise ValueError(f"an int8 corpus needs its ({n},) float32 block scales")
        if d > MAX_DIM:
            raise ValueError(f"dim {d} > {MAX_DIM}: raw int32 maxima would not "
                             "convert to f32 exactly")


def subtile_max_piped(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid: torch.Tensor,
    g: int = 16,
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, N/g) f32 sub-tile maxima, dead rows masked (NEG for an all-dead
    sub-tile). bf16/f32: ``queries`` already normalized (cosine) and cast to
    the corpus dtype. int8: ``queries`` are query codes and ``scale`` the
    corpus's per-row scales, one shared by every g-row sub-tile.

    CPU tensors take :func:`subtile_max_piped_plain`; CUDA tensors launch
    the kernel on the current stream or raise. g = 128 and 256 run the
    kernel at g = 64 and take the exact max of neighbours (:func:`widen_g`).
    bf16 and int8 operands that TMA cannot describe (a view off a 16-byte
    boundary, rows not a multiple of 16 bytes) are copied first
    (``subtile_max.tma_operands``)."""
    _check(queries, corpus, valid, g, scale)
    if corpus.device.type == "cpu":
        return subtile_max_piped_plain(queries, corpus, valid, g, scale)
    if corpus.device.type != "cuda":
        raise ValueError(f"no subtile_max_piped kernel for device {corpus.device}")
    tensors = [queries, corpus, valid] + ([scale] if scale is not None else [])
    if any(t.device != corpus.device for t in tensors):
        raise ValueError("queries, corpus, valid and scale must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("subtile_max_piped kernel needs contiguous tensors")
    b, d = queries.shape
    n = corpus.shape[0]
    if n >= 2**31 or b * d >= 2**31:
        raise ValueError("subtile_max_piped kernel indexes rows with 32-bit ints")
    kg = min(g, KERNEL_MAX_G)
    out = torch.empty((b, n // kg), dtype=torch.float32, device=corpus.device)
    if b == 0 or n == 0:
        return widen_g(out, g, kg)
    if corpus.dtype != torch.float32:
        queries, corpus = tma_operands(queries, corpus)
        d = corpus.shape[1]
    fn = load().lib.subtile_max_piped_launch
    with torch.cuda.device(corpus.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            queries.data_ptr(), corpus.data_ptr(), valid.view(torch.uint8).data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(),
            b, n, d, kg, _MODE[corpus.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"subtile_max_piped kernel launch failed: CUDA error {err}")
    count_launch(__name__)
    return widen_g(out, g, kg)
