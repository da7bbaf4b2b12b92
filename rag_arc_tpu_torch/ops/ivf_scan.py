"""IVF probe scan: the masked scores of every row of every probed list.

Counterpart of the probe gather and scoring inside
``rag_arc_tpu/index/ivf.py::_ivf_search_body`` (``:768-812``, an XLA
program, no Pallas kernel): between the probe selection and the final
top-k. On the card it runs the hand-written CUDA kernel
``csrc/ivf_scan.cu``, which reads each probed list where it lies; on the
CPU it runs :func:`ivf_scan_plain`, the gather + product of the JAX body
in torch, one probe rank at a time.

Inputs: ``q (B, d)`` f32, already normalized for cosine; ``probe (B,
nprobe)`` list ids; ``lists (nlist, Lmax, d)`` f32, bf16 or int8
(residual codes); ``sqnorm (nlist, Lmax)`` f32 (squared norms, or the
int8 rows' scales); ``valid (nlist, Lmax)`` bool; for int8 the f32
centroid cross ``(B, nlist)``. Output: ``(B, nprobe·Lmax)`` f32 in (probe
rank, slot) order, invalid slots at -inf. The JAX body's rounding points
are kept: q is cast to the list dtype (bf16 for int8 codes) and the
products are accumulated in f32; l2 is ``-(‖q‖² − 2·dot + sqnorm)`` with
‖q‖² of the f32 query; int8 is ``cross[c] + dot · scale``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from rag_arc_tpu_torch.ops._build import Built, build
from rag_arc_tpu_torch.ops.bm25 import full_f32_matmul

# kernel launches since the count was last set to 0; only the wrapper's
# CUDA branch adds to it
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MODE_CODE = {"ip": 0, "l2": 1, "resid": 2}
_MAX_SMEM_FLOATS = 12_288  # the query row in 48 KB of static-limit shared memory


def _mode(lists: torch.Tensor, metric: str) -> str:
    if lists.dtype == torch.int8:
        if metric == "l2":
            raise ValueError("int8 IVF storage supports cosine/ip, not l2")
        return "resid"
    return "l2" if metric == "l2" else "ip"


def _prepared(q: torch.Tensor, lists: torch.Tensor, mode: str):
    """The query as both versions multiply it (rounded to the list dtype,
    bf16 for int8 codes, widened to f32) and ‖q‖² of the f32 query."""
    q = q.float()
    cast = torch.bfloat16 if lists.dtype == torch.int8 else lists.dtype
    qc = q.to(cast).float().contiguous()
    q_sq = torch.sum(q * q, dim=1) if mode == "l2" else None
    return qc, q_sq


def _check(q, probe, lists, sqnorm, valid, cross, mode) -> None:
    if lists.ndim != 3 or lists.dtype not in _DTYPE_CODE:
        raise ValueError(
            f"expected (nlist, Lmax, d) f32, bf16 or int8 lists, got "
            f"{tuple(lists.shape)} {lists.dtype}"
        )
    nlist, lmax, d = lists.shape
    if q.ndim != 2 or q.shape[1] != d:
        raise ValueError(f"expected (B, {d}) queries, got {tuple(q.shape)}")
    if probe.ndim != 2 or probe.shape[0] != q.shape[0]:
        raise ValueError(f"expected (B, nprobe) probes, got {tuple(probe.shape)}")
    if sqnorm.shape != (nlist, lmax) or valid.shape != (nlist, lmax):
        raise ValueError("sqnorm and valid must be (nlist, Lmax)")
    if valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool, got {valid.dtype}")
    if mode == "resid" and (cross is None or cross.shape != (q.shape[0], nlist)):
        raise ValueError("int8 lists need the (B, nlist) f32 centroid cross")


def ivf_scan_plain(
    q: torch.Tensor,
    probe: torch.Tensor,
    lists: torch.Tensor,
    sqnorm: torch.Tensor,
    valid: torch.Tensor,
    metric: str = "cosine",
    cross: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version: per probe rank, gather the (B, Lmax, d)
    probed rows, widen them to f32 and take one batched f32 product (the
    JAX body's einsum, bounded to one probe rank at a time)."""
    mode = _mode(lists, metric)
    _check(q, probe, lists, sqnorm, valid, cross, mode)
    qc, q_sq = _prepared(q, lists, mode)
    b, nprobe = probe.shape
    lmax = lists.shape[1]
    out = torch.empty((b, nprobe, lmax), dtype=torch.float32, device=lists.device)
    with full_f32_matmul():
        for p in range(nprobe):
            c = probe[:, p]
            dot = torch.bmm(lists[c].float(), qc[:, :, None])[:, :, 0]
            if mode == "resid":
                s = torch.gather(cross, 1, c[:, None]) + dot * sqnorm[c]
            elif mode == "l2":
                s = -(q_sq[:, None] - 2.0 * dot + sqnorm[c])
            else:
                s = dot
            out[:, p] = torch.where(valid[c], s, float("-inf"))
    return out.reshape(b, nprobe * lmax)


@functools.lru_cache(maxsize=None)
def load() -> Built:
    """Build (once) and bind the CUDA kernel library."""
    built = build("ivf_scan")
    fn = built.lib.ivf_scan_launch
    p, l, i = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    fn.argtypes = [p, p, p, l, l, p, p, p, p, p, l, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    built.lib.ivf_scan_rows_per_block.restype = ctypes.c_int
    return built


def ivf_scan(
    q: torch.Tensor,
    probe: torch.Tensor,
    lists: torch.Tensor,
    sqnorm: torch.Tensor,
    valid: torch.Tensor,
    metric: str = "cosine",
    cross: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, nprobe·Lmax) f32 masked scores of the probed lists.

    CPU tensors take :func:`ivf_scan_plain` (``out``, if given, receives a
    copy); CUDA tensors launch ``csrc/ivf_scan.cu`` once on the current
    stream, or raise. ``out`` may be any (B, nprobe·Lmax) f32 view with a
    dense last axis (the index passes the front of a wider, padded
    buffer); ``lists`` may be a strided view with a dense last axis."""
    global launches
    if lists.device.type == "cpu":
        scores = ivf_scan_plain(q, probe, lists, sqnorm, valid, metric, cross)
        if out is None:
            return scores
        out.copy_(scores)
        return out
    if lists.device.type != "cuda":
        raise ValueError(f"no ivf_scan kernel for device {lists.device}")
    mode = _mode(lists, metric)
    _check(q, probe, lists, sqnorm, valid, cross, mode)
    nlist, lmax, d = lists.shape
    b, nprobe = probe.shape
    if lists.stride(2) != 1:
        raise ValueError("ivf_scan kernel needs lists with a dense last axis")
    if d > _MAX_SMEM_FLOATS:
        raise ValueError(f"ivf_scan kernel holds the query in shared memory: d <= "
                         f"{_MAX_SMEM_FLOATS}, got {d}")
    if nprobe > 65535:
        raise ValueError("ivf_scan kernel puts the probe rank on grid.y: nprobe <= 65535")
    width = nprobe * lmax
    if out is None:
        out = torch.empty((b, width), dtype=torch.float32, device=lists.device)
    elif (out.shape != (b, width) or out.dtype != torch.float32 or out.stride(1) != 1
          or out.device != lists.device):
        raise ValueError(f"out must be a ({b}, {width}) f32 view with a dense last axis "
                         f"on {lists.device}")
    if b == 0:
        return out
    qc, q_sq = _prepared(q, lists, mode)
    probe = probe.to(torch.int64).contiguous()
    sqnorm = sqnorm.float().contiguous()
    valid = valid.contiguous()
    if mode == "resid":
        cross = cross.float().contiguous()
    elem = lists.element_size()
    vec = int(
        lists.data_ptr() % 16 == 0
        and lists.stride(0) * elem % 16 == 0
        and lists.stride(1) * elem % 16 == 0
    )
    lib = load().lib
    with torch.cuda.device(lists.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ivf_scan_launch(
            qc.data_ptr(), probe.data_ptr(), lists.data_ptr(), lists.stride(0),
            lists.stride(1), sqnorm.data_ptr(), valid.view(torch.uint8).data_ptr(),
            None if cross is None else cross.data_ptr(),
            None if q_sq is None else q_sq.data_ptr(), out.data_ptr(), out.stride(0),
            b, nprobe, lmax, d, nlist, _DTYPE_CODE[lists.dtype], _MODE_CODE[mode], vec,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"ivf_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return out
