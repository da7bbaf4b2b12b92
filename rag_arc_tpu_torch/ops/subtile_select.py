"""Sub-tile select of the two-level top-k: each query's k largest sub-tile
maxima.

Counterpart of ``rag_arc_tpu/ops/two_level.py::iterative_argmax_resid``
(an XLA program, no Pallas kernel). For each row of a (B, C) f32 matrix
it returns the indices of the k largest entries (value descending, ties
toward the lower index), a liveness flag per pick (value > NEG / 2) and
the max of the entries not picked (NEG when none is left).

On the card :func:`iterative_argmax_resid` runs the hand-written CUDA
kernel ``csrc/subtile_select.cu`` (one launch, a block a row, one read
of x streamed through a ring of bulk copies, no loop over k); on the CPU
it runs :func:`iterative_argmax_resid_plain`, the JAX package's
tournament ported literally. Where a row has fewer than k
live entries the tournament re-picks positions while the kernel picks
distinct ones, so dead picks may differ; live picks, flags and the
residual are equal. -0.0 and +0.0 tie (the lower index first). Neither
version expects NaN: the producers write none.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from rag_arc_tpu_torch.ops._build import Built, build, count_launch
from rag_arc_tpu_torch.ops.subtile_max import NEG

# kernel launches since the count was last set to 0; only the wrapper's
# CUDA branch adds to it
launches = 0

# the kernel's shapes (csrc/subtile_select.cu)
STAGE = 2048  # entries a ring stage holds (8 KB)
CAP = 8192  # composites the shared candidate buffer holds
FAST_K1 = CAP - 2 * STAGE  # k + 1 up to this takes the shared buffer


def iterative_argmax_resid_plain(x: torch.Tensor, k: int, chunk: int = 512):
    """Plain PyTorch version: a hierarchical tournament, ported literally.
    One pass builds per-chunk (max, argmax); each of the k steps reads the
    (B, n_chunks) summary, re-reads the one chunk it picked from with
    every earlier pick in it masked, and writes that chunk's new (max,
    argmax) back. ``torch.argmax`` returns the first maximal index, which
    keeps the reference's tie order."""
    b, c = x.shape
    w = min(chunk, c)
    if c % w:
        for cand in (512, 256, 128):
            if cand <= chunk and c % cand == 0:
                w = cand
                break
    n_chunks = -(-c // w)
    c_pad = n_chunks * w
    if c_pad != c:
        x = F.pad(x, (0, c_pad - c), value=NEG)
    xc = x.reshape(b, n_chunks, w)
    cmax = torch.amax(xc, dim=2)
    carg = torch.argmax(xc, dim=2)
    rows = torch.arange(b, device=x.device)
    in_chunk = torch.arange(w, device=x.device)[None, :]
    picked = torch.full((b, k), -1, dtype=torch.int64, device=x.device)
    lives = []
    for j in range(k):
        bc = torch.argmax(cmax, dim=1)
        best = cmax[rows, bc]
        # exhausted rows re-pick sentinel positions; clamp so gathers stay
        # in range (the liveness flag marks them dead either way)
        idx = torch.clamp(carg[rows, bc] + bc * w, max=c - 1)
        picked[:, j] = idx
        vals = xc[rows, bc, :]
        cols = bc[:, None] * w + in_chunk
        hit = torch.any(cols[:, None, :] == picked[:, :, None], dim=1)
        vals = torch.where(hit, NEG, vals)
        cmax[rows, bc] = torch.amax(vals, dim=1)
        carg[rows, bc] = torch.argmax(vals, dim=1)
        lives.append(best > NEG * 0.5)
    return picked, torch.stack(lives, dim=1), torch.amax(cmax, dim=1)


@functools.lru_cache(maxsize=None)
def load() -> Built:
    """Build (once) and bind the CUDA kernel library."""
    built = build("subtile_select")
    fn = built.lib.subtile_select_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    for name in ("subtile_select_fast_k1", "subtile_select_stage"):
        getattr(built.lib, name).restype = ctypes.c_int
    cols = built.lib.subtile_select_scratch_cols
    cols.argtypes = [ctypes.c_int, ctypes.c_int]
    cols.restype = ctypes.c_int
    return built


def _check(x: torch.Tensor, k: int) -> None:
    if x.ndim != 2:
        raise ValueError(f"expected a (B, C) matrix, got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"expected float32 sub-tile maxima, got {x.dtype}")
    if not 1 <= k <= x.shape[1]:
        raise ValueError(f"k must lie in [1, C = {x.shape[1]}], got {k}")


def iterative_argmax_resid(x: torch.Tensor, k: int, chunk: int = 512):
    """(picked (B, k) int64, live (B, k) bool, resid (B,) f32) of the k
    largest entries of each row of the (B, C) f32 ``x``, 1 ≤ k ≤ C.

    CPU tensors take :func:`iterative_argmax_resid_plain` (``chunk`` is
    its chunk width); CUDA tensors launch ``csrc/subtile_select.cu`` once
    on the current stream, or raise."""
    _check(x, k)
    if x.device.type == "cpu":
        return iterative_argmax_resid_plain(x, k, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no subtile_select kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("subtile_select kernel needs a contiguous matrix")
    b, c = x.shape
    if c >= 2**31 - 1:
        raise ValueError("subtile_select kernel indexes entries with 32-bit ints")
    picked = torch.empty((b, k), dtype=torch.int64, device=x.device)
    live = torch.empty((b, k), dtype=torch.bool, device=x.device)
    resid = torch.empty((b,), dtype=torch.float32, device=x.device)
    if b == 0:
        return picked, live, resid
    lib = load().lib
    # k past the kernel's shared buffer: each row is sorted in a scratch row
    scratch_p = lib.subtile_select_scratch_cols(c, k)
    scratch = None
    if scratch_p:
        scratch = torch.empty((b, scratch_p), dtype=torch.int64, device=x.device)
    fn = lib.subtile_select_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            x.data_ptr(), b, c, k, picked.data_ptr(), live.view(torch.uint8).data_ptr(),
            resid.data_ptr(), None if scratch is None else scratch.data_ptr(), scratch_p, stream,
        )
    if err != 0:
        raise RuntimeError(f"subtile_select kernel launch failed: CUDA error {err}")
    count_launch(__name__)
    return picked, live, resid
