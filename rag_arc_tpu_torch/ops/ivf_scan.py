"""IVF probe scan: the masked scores of every row of every probed list.

Counterpart of the probe gather and scoring inside
``rag_arc_tpu/index/ivf.py::_ivf_search_body`` (``:768-812``, an XLA
program, no Pallas kernel): between the probe selection and the final
top-k. On the card it runs the hand-written CUDA kernel
``csrc/ivf_scan.cu``, which reads each probed list where it lies, once
for all the queries that probe it; on the CPU it runs
:func:`ivf_scan_plain`, the gather + product of the JAX body in torch,
one probe rank at a time.

The kernel inverts the probe array, list → the (b, p) pairs that probe
it, on the device: each block scans ``probe`` itself while B·nprobe ≤
``PROLOGUE_MAX`` (one launch), else :func:`probe_plan` builds a CSR by
counting sort first (a second launch, counted in ``launches_plan``).
Small groups of queries a list take the CUDA cores; large groups over
bf16 lists take ``wgmma`` (the CSR, then the groups' queries gathered in
its order). :func:`scan_schedule` makes these choices and sizes the
passes; :func:`probe_plan_plain` is the CSR's plain version.

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

from rag_arc_tpu_torch.ops._build import Built, build, count_launch
from rag_arc_tpu_torch.ops.bm25 import full_f32_matmul

# kernel launches since the count was last set to 0; only the wrappers'
# CUDA branches add to them (the scan, and the CSR plan at large B·nprobe)
launches = 0
launches_plan = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MODE_CODE = {"ip": 0, "l2": 1, "resid": 2}
_MAX_SMEM_FLOATS = 12_288  # the widest query a pass holds in shared memory
PROLOGUE_MAX = 1024  # B·nprobe a block inverts by scanning probe (csrc: PROLOGUE_MAX)
PASS_MAX = 8  # pairs a pass holds at most (csrc: QG)
PASS_BYTES = 32 * 1024  # shared memory for a pass's f32 queries
# a block's tile: 256 rows (csrc: ROWS, the most), streamed through the
# bulk-copy ring where the rows allow it. tools/kernel_ab.py's sweep on the
# card (NVIDIA H100 80GB HBM3) found it the fastest at B 1-8 on the pair
# grid too: 0.057-0.245 ms against 0.068-0.382 with 64-row tiles
TILE_ROWS = 256
RING = True
# the wgmma path's crossover, from the card (NVIDIA H100 80GB HBM3, 1M x 768
# bf16, 100 lists): wgmma scans faster from 0.64 queries a list, but its
# CSR plan and query gather add five kernels to a dispatch of ~63, so it
# starts where the CUDA cores' scan passes ~0.7 ms (2.56 a list: 0.61 ms
# against 0.46; 3.84: 0.79 against 0.51)
TC_MIN_GROUP = 3.5  # mean queries a list from which bf16 lists take the wgmma path
TC_MIN_B = 9  # ... and queries a dispatch: B <= 8 keeps its one launch (no plan, no gather)


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


def scan_schedule(b: int, nprobe: int, d: int, nlist: int, tc_ok: bool = False) -> dict:
    """The kernel's launch plan. ``tc``: the wgmma path, where ``tc_ok``
    (bf16 lists TMA can read: 16-byte-aligned, d % 8 == 0, cosine/ip/l2)
    and a dispatch holds ``TC_MIN_B`` queries and a list's group
    ``TC_MIN_GROUP`` on average, with ``tc_qb`` queries a pass (64, or 128
    past 64 on average); it always takes the CSR. Else the CUDA cores:
    ``csr`` (the probe inversion is a CSR built by a first launch, past
    ``PROLOGUE_MAX`` pairs), ``by_pair`` (one grid row a (b, p) pair, not a
    list, while pairs are fewer than lists), ``passes`` (the pairs a pass
    holds: up to ``PASS_MAX``, fewer where d is wide) and the pass's
    ``smem`` bytes (its queries, rows rounded to 16 bytes)."""
    dq = -(-d // 4) * 4
    passes = max(1, min(PASS_MAX, PASS_BYTES // (4 * dq)))
    group = b * nprobe / nlist
    tc = tc_ok and b >= TC_MIN_B and group >= TC_MIN_GROUP
    return {"tc": tc, "tc_qb": 64 if group <= 64 else 128,
            "csr": tc or b * nprobe > PROLOGUE_MAX, "by_pair": not tc and b * nprobe < nlist,
            "passes": passes, "smem": passes * dq * 4}


def probe_plan_plain(probe: torch.Tensor, nlist: int):
    """Plain PyTorch version of the probe inversion: (offsets (nlist + 1,),
    pairs (B·nprobe,)) int32, the pair ids i = b·nprobe + p grouped by
    list, list c's at ``pairs[offsets[c]:offsets[c + 1]]`` in id order."""
    flat = probe.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=nlist)[:nlist]
    offsets = torch.zeros(nlist + 1, dtype=torch.int64, device=probe.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return offsets.int(), order.int()


def probe_plan(probe: torch.Tensor, nlist: int):
    """The probe inversion as :func:`probe_plan_plain` defines it, the
    order within a list aside. CPU tensors take the plain version; CUDA
    tensors launch ``ivf_scan_plan_kernel`` once (one block, a counting
    sort: pairs within a list in any order), or raise."""
    if probe.ndim != 2:
        raise ValueError(f"expected (B, nprobe) probes, got {tuple(probe.shape)}")
    if probe.device.type == "cpu":
        return probe_plan_plain(probe, nlist)
    if probe.device.type != "cuda":
        raise ValueError(f"no probe plan kernel for device {probe.device}")
    n = probe.numel()
    if n >= 2**31 - 1 or nlist < 1:
        raise ValueError("probe plan kernel indexes pairs with 32-bit ints, nlist >= 1")
    probe = probe.to(torch.int64).contiguous()
    scratch = torch.empty(2 * nlist + 1 + n, dtype=torch.int32, device=probe.device)
    offsets, cursor, pairs = scratch[: nlist + 1], scratch[nlist + 1 : 2 * nlist + 1], \
        scratch[2 * nlist + 1 :]
    if n == 0:
        return offsets.zero_(), pairs
    with torch.cuda.device(probe.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = load().lib.ivf_scan_plan_launch(probe.data_ptr(), n, nlist, offsets.data_ptr(),
                                              cursor.data_ptr(), pairs.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"probe plan kernel launch failed: CUDA error {err}")
    count_launch(__name__, "launches_plan")
    return offsets, pairs


@functools.lru_cache(maxsize=None)
def load() -> Built:
    """Build (once) and bind the CUDA kernel library."""
    built = build("ivf_scan")
    fn = built.lib.ivf_scan_launch
    p, l, i = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, l, l, p, p, p, p, p, l, i, i, i, i, i, i, i, i, i, i, i, i,
                   p]
    fn.restype = ctypes.c_int
    plan = built.lib.ivf_scan_plan_launch
    plan.argtypes = [p, i, i, p, p, p, p]
    plan.restype = ctypes.c_int
    tc = built.lib.ivf_scan_tc_launch
    tc.argtypes = [p, p, p, p, l, l, p, p, p, p, l, i, i, i, i, i, i, i, p]
    tc.restype = ctypes.c_int
    for name in ("ivf_scan_prologue_max", "ivf_scan_pass_max"):
        getattr(built.lib, name).restype = ctypes.c_int
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
    stream (after :func:`probe_plan` past ``PROLOGUE_MAX`` pairs), or
    raise. ``out`` may be any (B, nprobe·Lmax) f32 view with a
    dense last axis (the index passes the front of a wider, padded
    buffer); ``lists`` may be a strided view with a dense last axis.
    :func:`scan_schedule` picks the kernel's path and grid."""
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
    tc_ok = bool(vec) and lists.dtype == torch.bfloat16 and d % 8 == 0
    sched = scan_schedule(b, nprobe, d, nlist, tc_ok)
    offsets = pairs = None
    if sched["csr"]:
        offsets, pairs = probe_plan(probe, nlist)
    lib = load().lib
    if sched["tc"]:
        # the groups' queries, in CSR order, as bf16 rows (exact: qc is bf16)
        qg = qc.to(torch.bfloat16).index_select(0, torch.div(pairs, nprobe,
                                                             rounding_mode="floor").long())
        with torch.cuda.device(lists.device):
            err = lib.ivf_scan_tc_launch(
                qg.data_ptr(), offsets.data_ptr(), pairs.data_ptr(), lists.data_ptr(),
                lists.stride(0), lists.stride(1), sqnorm.data_ptr(),
                valid.view(torch.uint8).data_ptr(), None if q_sq is None else q_sq.data_ptr(),
                out.data_ptr(), out.stride(0), b * nprobe, nprobe, lmax, d, nlist,
                _MODE_CODE[mode], sched["tc_qb"], torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"ivf_scan wgmma kernel launch failed: CUDA error {err}")
        count_launch(__name__)
        return out
    with torch.cuda.device(lists.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ivf_scan_launch(
            qc.data_ptr(), probe.data_ptr(),
            None if offsets is None else offsets.data_ptr(),
            None if pairs is None else pairs.data_ptr(), lists.data_ptr(), lists.stride(0),
            lists.stride(1), sqnorm.data_ptr(), valid.view(torch.uint8).data_ptr(),
            None if cross is None else cross.data_ptr(),
            None if q_sq is None else q_sq.data_ptr(), out.data_ptr(), out.stride(0),
            b, nprobe, lmax, d, nlist, sched["passes"], int(sched["by_pair"]),
            TILE_ROWS, int(RING), _DTYPE_CODE[lists.dtype],
            _MODE_CODE[mode], vec, stream,
        )
    if err != 0:
        raise RuntimeError(f"ivf_scan kernel launch failed: CUDA error {err}")
    count_launch(__name__)
    return out
