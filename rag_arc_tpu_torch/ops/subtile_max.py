"""Sub-tile max producer of the two-level top-k.

Counterpart of ``rag_arc_tpu/ops/two_level_stream.py::subtile_max_stream``
and of the ``_subtile_max_kernel_ip`` producer inside
``rag_arc_tpu/ops/two_level.py::two_level_topk``. On the card it runs the
hand-written CUDA kernel ``csrc/subtile_max.cu`` (bf16: wgmma fed by TMA;
f32: CUDA-core FMAs); on the CPU it runs :func:`subtile_max_plain`, the
same function in plain PyTorch.

With ``sqnorm`` given it runs the l2 mode, the counterpart of
``rag_arc_tpu/ops/two_level.py::_subtile_max_kernel`` (the l2 producer
of ``two_level_topk(metric="l2")``): each row scores
``-(‖q‖² - 2 q·x + ‖x‖²)`` before the mask and the sub-tile max.

Layout: the result is (B, N/g) — the transpose of the TPU kernels'
(N/g, B). The select stage reads each query's sub-tile maxima as one
contiguous row; the TPU layout existed to keep B on the 128-wide lane
axis.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from rag_arc_tpu_torch.ops._build import Built, build, count_launch

NEG = -3.0e38  # sentinel below any real score (avoids inf - inf)

SUPPORTED_G = (16, 32, 64, 128, 256)
# rows a kernel block reduces: a wider g is served from g = 128 maxima
KERNEL_MAX_G = 128

# kernel launches since the counts were last set to 0, cosine/ip and l2
# mode apart; only the wrapper's CUDA branch adds to them
launches = 0
launches_l2 = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def query_sqnorm(queries: torch.Tensor) -> torch.Tensor:
    """(B,) f32 ‖q‖² of the queries as the kernel sees them (cast to the
    corpus dtype, widened to f32)."""
    q32 = queries.float()
    return torch.sum(q32 * q32, dim=1)


def widen_g(sub: torch.Tensor, g: int, kernel_g: int) -> torch.Tensor:
    """(B, N/g) maxima from (B, N/kernel_g) maxima: the exact pairwise max
    of neighbouring sub-tiles (g a multiple of kernel_g)."""
    if g == kernel_g:
        return sub
    return sub.reshape(sub.shape[0], -1, g // kernel_g).amax(dim=2)


def subtile_max_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid: torch.Tensor,
    g: int,
    sqnorm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version: (B, N/g) f32 maxima of the f32-accumulated
    scores over each g-row sub-tile, dead rows scoring NEG; with
    ``sqnorm`` the scores are the l2 ``-(‖q‖² - 2 q·x + ‖x‖²)``."""
    n = corpus.shape[0]
    scores = queries.float() @ corpus.float().T
    if sqnorm is not None:
        q_sq = query_sqnorm(queries)[:, None]
        scores = -(q_sq - 2.0 * scores + sqnorm[None, :])
    scores = torch.where(valid[None, :].bool(), scores, NEG)
    return scores.reshape(queries.shape[0], n // g, g).amax(dim=2)


def tma_operands(queries: torch.Tensor, corpus: torch.Tensor):
    """The operands as the kernels' TMA loads need them: bases on a
    16-byte boundary and rows of a multiple of 16 bytes (8 bf16, 16
    int8). An operand that is not (a view with a storage offset, a width
    off that multiple) is copied into fresh storage, zero-padded in d:
    zero columns leave every dot product unchanged. This is a copy, not a
    fallback: the kernel still runs. The index's own storage (d = 768, its
    own allocation) goes through as it is."""
    d = corpus.shape[1]
    per = 16 // corpus.element_size()
    width = -(-d // per) * per

    def fit(t: torch.Tensor) -> torch.Tensor:
        if width == d and t.data_ptr() % 16 == 0:
            return t
        out = t.new_zeros((t.shape[0], width))
        out[:, :d] = t
        return out

    return fit(queries), fit(corpus)


@functools.lru_cache(maxsize=None)
def load() -> Built:
    """Build (once) and bind the CUDA kernel library."""
    built = build("subtile_max")
    fn = built.lib.subtile_max_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return built


def _check(queries, corpus, valid, g, sqnorm) -> None:
    if queries.ndim != 2 or corpus.ndim != 2 or queries.shape[1] != corpus.shape[1]:
        raise ValueError(
            f"expected queries (B, d) and corpus (N, d), got "
            f"{tuple(queries.shape)} and {tuple(corpus.shape)}"
        )
    n = corpus.shape[0]
    if valid.shape != (n,):
        raise ValueError(f"valid must be ({n},), got {tuple(valid.shape)}")
    if g not in SUPPORTED_G:
        raise ValueError(f"g must be one of {SUPPORTED_G}, got {g}")
    if n % g:
        raise ValueError(f"corpus rows {n} not a multiple of g {g}")
    if queries.dtype != corpus.dtype:
        raise ValueError(
            f"queries {queries.dtype} and corpus {corpus.dtype} differ"
        )
    if sqnorm is not None and (sqnorm.shape != (n,) or sqnorm.dtype != torch.float32):
        raise ValueError(f"sqnorm must be ({n},) float32")


def subtile_max(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid: torch.Tensor,
    g: int = 16,
    sqnorm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, N/g) f32: ``out[b, t] = max over the rows r of sub-tile t of
    (valid[r] ? score(b, r) : NEG)`` with ``score = queries[b]·corpus[r]``,
    or, given the corpus's f32 ``sqnorm`` (l2 mode),
    ``-(‖queries[b]‖² - 2 queries[b]·corpus[r] + sqnorm[r])``.

    ``queries`` are already normalized (cosine) and cast to the corpus
    dtype (f32 or bf16). CPU tensors take :func:`subtile_max_plain`; CUDA
    tensors launch the kernel on the current stream or raise. g = 256 runs
    the kernel at g = 128 and takes the pairwise max (:func:`widen_g`).
    bf16 operands that TMA cannot describe are copied first
    (:func:`tma_operands`)."""
    _check(queries, corpus, valid, g, sqnorm)
    if corpus.device.type == "cpu":
        return subtile_max_plain(queries, corpus, valid, g, sqnorm)
    if corpus.device.type != "cuda":
        raise ValueError(f"no subtile_max kernel for device {corpus.device}")
    if queries.device != corpus.device or valid.device != corpus.device:
        raise ValueError("queries, corpus and valid must share one device")
    if corpus.dtype not in _DTYPE_CODE:
        raise ValueError(f"subtile_max kernel takes f32 or bf16, not {corpus.dtype}")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"valid must be bool or uint8, not {valid.dtype}")
    if not (queries.is_contiguous() and corpus.is_contiguous() and valid.is_contiguous()):
        raise ValueError("subtile_max kernel needs contiguous tensors")
    q_sq = None
    if sqnorm is not None:
        if sqnorm.device != corpus.device or not sqnorm.is_contiguous():
            raise ValueError("sqnorm must be contiguous on the corpus's device")
        q_sq = query_sqnorm(queries)
    b, d = queries.shape
    n = corpus.shape[0]
    if n >= 2**31 or b * d >= 2**31:
        raise ValueError("subtile_max kernel indexes rows with 32-bit ints")
    kg = min(g, KERNEL_MAX_G)
    out = torch.empty((b, n // kg), dtype=torch.float32, device=corpus.device)
    if b == 0 or n == 0:
        return widen_g(out, g, kg)
    if corpus.dtype == torch.bfloat16:
        queries, corpus = tma_operands(queries, corpus)
        d = corpus.shape[1]
    fn = load().lib.subtile_max_launch
    with torch.cuda.device(corpus.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            queries.data_ptr(), corpus.data_ptr(),
            valid.view(torch.uint8).data_ptr(),
            None if q_sq is None else q_sq.data_ptr(),
            None if sqnorm is None else sqnorm.data_ptr(),
            out.data_ptr(), b, n, d, kg, _DTYPE_CODE[corpus.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"subtile_max kernel launch failed: CUDA error {err}")
    count_launch(__name__, "launches" if sqnorm is None else "launches_l2")
    return widen_g(out, g, kg)
