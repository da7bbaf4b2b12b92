"""Fused MIPS + top-k: (B, k) scores and positions with no (B, N) score
matrix in device memory.

Counterpart of ``rag_arc_tpu/ops/fused_mips.py::fused_mips_topk`` (the
"r1" kernel ``_fused_kernel`` at :50, driven by the kernel probe). On the card it
runs the hand-written CUDA kernels of ``csrc/fused_mips.cu`` (a grid of
corpus split x query block keeping running lists in shared memory: bf16
scores on ``wgmma`` in a warpgroup ping-pong, filtered in registers against
each query's k-th and folded under the next tile's products; then a merge
of the splits' lists); on the CPU it runs
:func:`fused_mips_topk_plain`, which follows the TPU kernel's rules tile by
tile.

The function, read from the TPU kernel:

- not packed: the top k under (score desc, position asc);
- packed (``(tile_n - 1).bit_length() <= 16``, for every metric as the TPU
  code applies it): each score is quantized by the order-preserving key
  transform with the low ``idx_bits`` of the key cleared (positive scores
  lose those bits, negative ones get them set), the returned score is the
  quantized value, and the order is (quantized score desc, tile asc,
  in-tile column desc);
- dead rows never enter; slots beyond the live count are (NEG, -1);
- ``skip_tiles`` (the threshold early exit) does not change the result: a
  score at or below a query's current k-th loses to the running list. The
  plain version keeps the TPU's extraction rounds for both values; the
  kernel serves both through its threshold filter.

Metrics: cosine (queries normalized here, corpus pre-normalized), ip, and
l2 as ``-(‖q‖² - 2 q·x + ‖x‖²)`` with the corpus ``sqnorm``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from rag_arc_tpu_torch.ops._build import Built, build, count_launch
from rag_arc_tpu_torch.ops.subtile_max import NEG, tma_operands
from rag_arc_tpu_torch.ops.topk import stable_topk
from rag_arc_tpu_torch.ops.two_level import prepare_queries

MAX_K = 128  # list entries a block of the kernel keeps per query

SMEM_LIMIT = 232_448  # shared memory an H100 block may take (227 KB)
_FLIP = 0x7FFFFFFF

# kernel launches since the count was last set to 0; only the wrapper's
# CUDA branch adds to it (one per call: the fused kernel and its merge)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def packed_bits(tile_n: int, packed: bool) -> int:
    """The packed mode's index bits, or 0 when the mode is off (the TPU
    kernel packs only while the in-tile index fits in 16 bits)."""
    idx_bits = (tile_n - 1).bit_length()
    return idx_bits if packed and idx_bits <= 16 else 0


def quantize_keys(scores: torch.Tensor, idx_bits: int) -> torch.Tensor:
    """int32 keys of f32 scores under the order-preserving transform, low
    ``idx_bits`` cleared."""
    bits = scores.contiguous().view(torch.int32)
    keyed = torch.where(bits >= 0, bits, bits ^ _FLIP)
    return keyed & ~((1 << idx_bits) - 1)


def _decode_keys(keys: torch.Tensor) -> torch.Tensor:
    return torch.where(keys >= 0, keys, keys ^ _FLIP).view(torch.float32)


def _check(queries, corpus, valid, sqnorm, k, tile_n, metric) -> None:
    if queries.ndim != 2 or corpus.ndim != 2 or queries.shape[1] != corpus.shape[1]:
        raise ValueError(
            f"expected queries (B, d) and corpus (N, d), got "
            f"{tuple(queries.shape)} and {tuple(corpus.shape)}"
        )
    n = corpus.shape[0]
    if tile_n < 1 or n % tile_n != 0:
        raise ValueError(f"corpus rows {n} not a multiple of tile_n {tile_n}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if metric not in ("cosine", "ip", "l2"):
        raise ValueError(f"unknown metric {metric!r}")
    if corpus.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_mips_topk takes f32 or bf16 corpora, not {corpus.dtype}")
    if valid.shape != (n,) or valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"valid must be ({n},) bool or uint8")
    if metric == "l2" and (sqnorm is None or sqnorm.shape != (n,)):
        raise ValueError(f"l2 needs the corpus's ({n},) sqnorm")


def fused_mips_topk_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid: torch.Tensor,
    sqnorm: torch.Tensor,
    k: int,
    tile_n: int = 1024,
    metric: str = "cosine",
    skip_tiles: bool = False,
    packed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, the TPU kernel's rules tile by tile: each
    tile's top k (at most the count of scores above the running k-th with
    ``skip_tiles``), then a stable merge with the running list."""
    qc = prepare_queries(queries, corpus.dtype, metric)
    q32 = qc.float()
    b, n = q32.shape[0], corpus.shape[0]
    idx_bits = packed_bits(tile_n, packed)
    low = (1 << idx_bits) - 1
    cols = torch.arange(tile_n, dtype=torch.int32, device=corpus.device)
    run_s = torch.full((b, k), NEG, dtype=torch.float32, device=corpus.device)
    run_p = torch.full((b, k), -1, dtype=torch.int64, device=corpus.device)
    q_sq = torch.sum(q32 * q32, dim=1, keepdim=True) if metric == "l2" else None
    for base in range(0, n, tile_n):
        scores = q32 @ corpus[base : base + tile_n].float().T
        if q_sq is not None:
            scores = -(q_sq - 2.0 * scores + sqnorm[None, base : base + tile_n].float())
        scores = torch.where(valid[None, base : base + tile_n].bool(), scores, NEG)
        rounds = min(k, tile_n)
        if skip_tiles:
            theta = run_s.amin(dim=1, keepdim=True)
            count = int((scores > theta).sum(dim=1).max())
            if count == 0:
                continue
            rounds = min(rounds, count)
        if idx_bits:
            pack = quantize_keys(scores, idx_bits) | cols
            top = torch.topk(pack, rounds, dim=1).values  # keys are unique
            ts = _decode_keys(top & ~low)
            tp = (top & low).long() + base
        else:
            ts, ti = stable_topk(scores, rounds)
            tp = ti + base
        ts = F.pad(ts, (0, k - rounds), value=NEG)
        tp = F.pad(tp, (0, k - rounds), value=-1)
        run_s, order = stable_topk(torch.cat([run_s, ts], dim=1), k)
        run_p = torch.gather(torch.cat([run_p, tp], dim=1), 1, order)
    return run_s, run_p


@functools.lru_cache(maxsize=None)
def load() -> Built:
    """Build (once) and bind the CUDA kernel library."""
    built = build("fused_mips")
    fn = built.lib.fused_mips_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return built


@dataclasses.dataclass(frozen=True)
class Schedule:
    """How the kernel cuts one call: a grid of ``splits`` corpus splits of
    ``per`` tiles of ``rows`` rows each, times query blocks of ``qb``, each
    block taking ``smem`` bytes of shared memory."""

    qb: int
    rows: int
    splits: int
    per: int
    smem: int


def _bf16_smem(qb: int, k: int) -> int:
    """The bf16 kernel's shared memory (``WLayout`` in the source): 1 KB
    alignment slack, a 4-stage ring of 64-row corpus and qb-query slices
    of 128 bytes, 64 candidates a query, counts and ‖q‖², 8 mbarriers,
    and the (qb, k) lists of scores and positions."""
    return 1024 + 4 * (64 * 128 + qb * 128) + qb * 64 * 8 + qb * 8 + 64 + qb * k * 8


def _f32_smem(k: int) -> int:
    """The f32 kernel's: a 3-stage ring of 128-row and 64-query 80-byte
    rows, the (64, 132) f32 score slab and the (64, k) lists."""
    return 3 * (128 * 80 + 64 * 80) + 64 * 132 * 4 + 64 * k * 8


def schedule(n: int, b: int, k: int, sms: int, dtype: torch.dtype) -> Schedule:
    """The kernel's grid for N = ``n`` rows, B = ``b`` queries and k on a
    card of ``sms`` SMs. bf16: 64-row tiles, a query block of 128 (64 when
    B ≤ 64, or when k's lists would not fit beside the ring), and about one
    block per SM; f32: 128-row chunks, 64 queries, about four blocks per SM.
    Every tile lies in exactly one split."""
    if dtype == torch.bfloat16:
        qb = 64 if b <= 64 or _bf16_smem(128, k) > SMEM_LIMIT else 128
        rows, smem, target = 64, _bf16_smem(qb, k), sms
    else:
        qb, rows, smem, target = 64, 128, _f32_smem(k), 4 * sms
    n_tiles = -(-n // rows)
    n_qblk = -(-b // qb)
    splits = max(1, min(n_tiles, target // n_qblk))
    per = -(-n_tiles // splits)
    return Schedule(qb, rows, -(-n_tiles // per), per, smem)


def fused_mips_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid: torch.Tensor,
    sqnorm: torch.Tensor,
    k: int,
    tile_n: int = 1024,
    q_block: int = 256,
    metric: str = "cosine",
    skip_tiles: bool = False,
    packed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, d) × (N, d) → top-k (scores (B, k) f32, positions (B, k) int64),
    the JAX package's signature. N must be a multiple of ``tile_n``, which
    defines the packed quantization and its tie order; any B is taken
    (``q_block``, the TPU kernel's query block, is accepted and unused).
    For cosine the corpus must be pre-normalized; queries are normalized
    here. k ≤ ``MAX_K``.

    CPU tensors take :func:`fused_mips_topk_plain`; CUDA tensors launch the
    kernels on the current stream or raise. Operands that the kernels'
    loads cannot describe (a view off a 16-byte boundary, rows not a
    multiple of 16 bytes) are copied first (``subtile_max.tma_operands``);
    ``skip_tiles`` picks the plain version's schedule only."""
    del q_block
    _check(queries, corpus, valid, sqnorm, k, tile_n, metric)
    if corpus.device.type == "cpu":
        return fused_mips_topk_plain(queries, corpus, valid, sqnorm, k, tile_n, metric,
                                     skip_tiles, packed)
    if corpus.device.type != "cuda":
        raise ValueError(f"no fused_mips kernel for device {corpus.device}")
    qc = prepare_queries(queries, corpus.dtype, metric)
    l2 = metric == "l2"
    tensors = [qc, corpus, valid] + ([sqnorm] if l2 else [])
    if any(t.device != corpus.device for t in tensors):
        raise ValueError("queries, corpus, valid and sqnorm must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_mips kernel needs contiguous tensors")
    b, d = qc.shape
    n = corpus.shape[0]
    if n >= 2**31 or b * d >= 2**31:
        raise ValueError("fused_mips kernel indexes rows with 32-bit ints")
    out_s = torch.empty((b, k), dtype=torch.float32, device=corpus.device)
    out_p = torch.empty((b, k), dtype=torch.int32, device=corpus.device)
    if b == 0:
        return out_s, out_p.long()
    q_sq = sq = None
    if l2:
        q32 = qc.float()
        q_sq = torch.sum(q32 * q32, dim=1).contiguous()
        sq = sqnorm.float().contiguous()
    qc, corpus = tma_operands(qc, corpus)
    d = corpus.shape[1]
    sms = torch.cuda.get_device_properties(corpus.device).multi_processor_count
    plan = schedule(n, b, k, sms, corpus.dtype)
    part_s = torch.empty((plan.splits, b, k), dtype=torch.float32, device=corpus.device)
    part_p = torch.empty((plan.splits, b, k), dtype=torch.int32, device=corpus.device)
    idx_bits = packed_bits(tile_n, packed)
    fn = load().lib.fused_mips_launch
    with torch.cuda.device(corpus.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            qc.data_ptr(), corpus.data_ptr(), valid.view(torch.uint8).data_ptr(),
            None if q_sq is None else q_sq.data_ptr(), None if sq is None else sq.data_ptr(),
            part_s.data_ptr(), part_p.data_ptr(), out_s.data_ptr(), out_p.data_ptr(),
            b, n, d, k, tile_n, int(idx_bits > 0), idx_bits, plan.splits, plan.per, plan.qb,
            _DTYPE_CODE[corpus.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_mips kernel launch failed: CUDA error {err}")
    count_launch(__name__)
    return out_s, out_p.long()
