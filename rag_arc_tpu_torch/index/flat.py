"""Device-resident flat (exact) vector index (counterpart of
``rag_arc_tpu/index/flat.py::DeviceFlatIndex``).

- The corpus is a capacity-padded tensor ``emb (capacity, dim)`` with a
  ``valid (capacity,)`` tombstone mask and an f32 ``sqnorm`` column: the
  rows' squared norms for the l2 metric, or, in int8 mode, each row's
  dequantization scale. Capacity grows by doubling, in ``ADD_BLOCK``
  multiples.
- Deletes clear the mask bit and zero the row, so dead rows score 0
  under cosine/ip and snapshots stay interchangeable with the JAX
  package's.
- Search: a score matrix within ``SCORE_BYTES_BUDGET`` takes the direct
  product + top-k; a larger one takes the two-level path, whose sub-tile
  max is the CUDA kernel on the card. The two-level producer is masked,
  so it is exact without the TPU path's certificate.

int8 mode (``dtype=torch.int8``, cosine/ip) stores symmetric int8 codes
with ONE scale per ``QUANT_BLOCK`` aligned rows, so the int8 kernel's raw
sub-tile maxima scale exactly (``SUBTILE_G`` divides ``QUANT_BLOCK``). A
partial tail block is filled by the next add at the cached tail scale;
a row outside that scale's range realigns the cursor and leaves gap rows
(zero codes, never valid). An optional residual sidecar (``refine``:
int4 nibble-packed or int8 codes of x − dequant(x), one scale per row)
refines the rescore of the ``kf_mult·k`` over-fetched candidates with the
f32 query. Search is exact under the quantized metric.

Every int8 search on a CUDA tensor takes the kernel path, whatever its
size. The JAX package's direct int8 path scores against an f32 copy of
the whole corpus (6.4 GB at 2²¹ × 768), which a single query would
allocate on the card; the kernel reads the codes as they are, and since
it is exact under the quantized metric its ids are the direct path's up
to the order of equal scores. On the CPU the direct path stays for score
matrices within the budget (widened in row chunks), as in the JAX
package, and larger ones take the kernel's plain version.

Tensors are updated in place (the JAX package rebuilt donated buffers).
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from rag_arc_tpu_torch.utils.tracing import stage
from rag_arc_tpu_torch.utils.transfers import current_pool
from rag_arc_tpu_torch.ops.scoring import NEG_INF, dot_f32
from rag_arc_tpu_torch.ops.topk import masked_topk, stable_topk
from rag_arc_tpu_torch.ops.two_level import (
    normalize_rows,
    quantize_queries,
    quantize_rows_blocked,
    row_norm,
    two_level_topk,
    two_level_topk_i8,
)

logger = logging.getLogger(__name__)

ADD_BLOCK = 1024  # capacity granularity
QUANT_BLOCK = 32  # int8 mode: rows per shared quantization scale

_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def _pad_pow2(n: int, minimum: int) -> int:
    return max(minimum, 1 << math.ceil(math.log2(max(n, 1))))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def fetch_pair(
    scores: torch.Tensor, positions: torch.Tensor
) -> Tuple[np.ndarray, np.ndarray]:
    """Read (scores f32, positions) back to the host in ONE transfer: the
    int32 positions ride beside the scores as f32 bit patterns."""
    k = scores.shape[1]
    packed = torch.cat(
        [scores.float(), positions.to(torch.int32).view(torch.float32)], dim=1
    ).cpu().numpy()
    return packed[:, :k], packed[:, k:].view(np.int32).astype(np.int64)


def pair_readback(
    scores: torch.Tensor, positions: torch.Tensor
) -> Callable[[], Tuple[np.ndarray, np.ndarray]]:
    """A fetch for a dispatched (scores, positions) pair: under an active
    ``TransferPool`` the pair rides the stream's one pooled flush,
    otherwise :func:`fetch_pair` reads it back in one transfer."""
    pool = current_pool()
    if pool is None:
        return lambda: fetch_pair(scores, positions)
    handle = pool.register((scores, positions))

    def fetch() -> Tuple[np.ndarray, np.ndarray]:
        s, p = pool.result(handle)
        return s.astype(np.float32, copy=False), p.astype(np.int64)

    return fetch


def normalize_raw(
    scores: np.ndarray, positions: np.ndarray, b: int, k: int, k_eff: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Host boundary: trim batch padding, map both device sentinels (-inf
    from the direct path, the finite NEG=-3e38 from the two-level path) to
    the documented -inf / -1, and pad out to k columns."""
    scores = scores[:b]
    positions = positions[:b].astype(np.int64)
    positions = np.where(np.isneginf(scores) | (scores <= -1.0e38), -1, positions)
    scores = np.where(positions < 0, -np.inf, scores).astype(np.float32)
    if k_eff < k:
        pad = k - k_eff
        scores = np.pad(scores, ((0, 0), (0, pad)), constant_values=-np.inf)
        positions = np.pad(positions, ((0, 0), (0, pad)), constant_values=-1)
    return scores, positions


# -- int8 residual sidecar ----------------------------------------------------


def encode_residual(resid: np.ndarray, kind: str) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row residual codes: int4 packs two codes/byte (offset-8
    nibbles, even dims low / odd dims high), int8 is plain."""
    amax = np.abs(resid).max(axis=1)
    if kind == "int4":
        scale = np.where(amax > 0, amax / 7.0, 1.0).astype(np.float32)
        c = (
            np.clip(np.rint(resid / scale[:, None]), -7, 7).astype(np.int8) + 8
        ).astype(np.uint8)
        return (c[:, 0::2] | (c[:, 1::2] << 4)).astype(np.uint8), scale
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    codes = np.clip(np.rint(resid / scale[:, None]), -127, 127).astype(np.int8)
    return codes, scale


def decode_residual(rows: torch.Tensor, kind: str) -> torch.Tensor:
    """Residual codes of gathered rows (..., cols) → f32 (..., dim)."""
    if kind == "int4":
        lo = (rows & 15).float() - 8.0
        hi = (rows >> 4).float() - 8.0
        return torch.stack([lo, hi], dim=-1).reshape(*rows.shape[:-1], -1)
    return rows.float()


def decode_residual_np(rows: np.ndarray, kind: str) -> np.ndarray:
    if kind == "int4":
        lo = (rows & 15).astype(np.float32) - 8.0
        hi = (rows >> 4).astype(np.float32) - 8.0
        return np.stack([lo, hi], axis=-1).reshape(*rows.shape[:-1], -1)
    return rows.astype(np.float32)


def _i8_topk_direct(
    q: torch.Tensor, emb: torch.Tensor, row_scale: torch.Tensor,
    valid: torch.Tensor, k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct int8 top-k under the quantized metric (the JAX package's
    ``_i8_topk_body``): integer-valued f32 products, exact. CPU only."""
    q_i8, qscale = quantize_queries(q)
    scores = dot_f32(q_i8.float(), emb) * row_scale[None, :]
    scores = torch.where(valid[None, :], scores, NEG_INF)
    s, p = stable_topk(scores, k)
    return s * qscale, p


class DeviceFlatIndex:
    """Exact MIPS/L2/cosine index over device-resident vectors."""

    # direct-path budget for the (B, N) f32 score matrix; above it the
    # search takes the two-level path
    SCORE_BYTES_BUDGET = 1 << 30

    # rows per pass-1 sub-tile max (the kernels' g); divides QUANT_BLOCK
    SUBTILE_G = 16

    # test hook: take the two-level path whatever the score matrix size
    _force_two_level = False

    def __init__(
        self,
        dim: int,
        metric: str = "cosine",
        capacity: int = 4096,
        dtype: torch.dtype = torch.float32,
        mesh: Optional[object] = None,
        *,
        device: torch.device | str,
        rescore_i8: bool = True,
        refine: Optional[str] = "default",
        kf_mult: int = 2,
    ):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {_DTYPES}, got {dtype}")
        if mesh is not None:
            raise NotImplementedError(
                "sharded indexes are not ported yet (ROADMAP Queue 1 #15)"
            )
        if metric not in ("cosine", "ip", "l2"):
            raise ValueError(f"unknown metric {metric!r}")
        self.dim = int(dim)
        self.metric = metric
        self.dtype = dtype
        self.device = torch.device(device)
        self.quantized = dtype == torch.int8
        # int8: over-fetch candidates and rescore them with the f32 query
        self.rescore_i8 = bool(rescore_i8)
        if refine not in (None, "int4", "int8", "default"):
            raise ValueError("refine must be None, 'int4' or 'int8'")
        if refine == "default":
            # int4 nibble-packing needs an even dim
            refine = "int4" if dim % 2 == 0 else "int8"
        self.refine = refine if self.quantized else None
        if kf_mult < 1:
            raise ValueError("kf_mult must be >= 1")
        self.kf_mult = int(kf_mult)
        if self.refine == "int4" and dim % 2:
            raise ValueError("int4 refine needs an even dim (2 codes/byte)")
        if self.quantized and metric == "l2":
            raise ValueError("int8 storage supports cosine/ip, not l2")
        self.capacity = _round_up(max(capacity, ADD_BLOCK), ADD_BLOCK)
        self.size = 0  # high-water mark of written rows
        self.n_deleted = 0
        self._gap_rows = 0  # int8 block-alignment padding rows (never valid)
        self._tail_scale = 0.0  # int8: scale of the partial tail block
        self._alloc(self.capacity)

    def _alloc(self, capacity: int) -> None:
        self.emb = torch.zeros((capacity, self.dim), dtype=self.dtype, device=self.device)
        self.valid = torch.zeros((capacity,), dtype=torch.bool, device=self.device)
        # in int8 mode sqnorm holds the per-row dequantization scale
        self.sqnorm = torch.zeros((capacity,), dtype=torch.float32, device=self.device)
        self._alloc_res(capacity)

    def _alloc_res(self, capacity: int) -> None:
        if self.refine:
            cols = self.dim // 2 if self.refine == "int4" else self.dim
            dtype = torch.uint8 if self.refine == "int4" else torch.int8
            self.res = torch.zeros((capacity, cols), dtype=dtype, device=self.device)
            self.res_scale = torch.zeros((capacity,), dtype=torch.float32, device=self.device)
        else:
            self.res = self.res_scale = None

    def _arrays(self):
        return [a for a in (self.emb, self.valid, self.sqnorm, self.res, self.res_scale)
                if a is not None]

    def _grow_to(self, min_capacity: int) -> None:
        new_cap = self.capacity
        while new_cap < min_capacity:
            new_cap *= 2
        new_cap = _round_up(new_cap, ADD_BLOCK)
        if new_cap == self.capacity:
            return
        logger.info("growing index capacity %d → %d", self.capacity, new_cap)
        old = self._arrays()
        self.capacity = new_cap
        self._alloc(new_cap)
        for new, prev in zip(self._arrays(), old):
            new[: prev.shape[0]] = prev

    def _put(self, dst: torch.Tensor, start: int, rows: np.ndarray) -> None:
        dst[start : start + len(rows)] = torch.from_numpy(
            np.ascontiguousarray(rows)
        ).to(self.device, dst.dtype)

    # -- mutation ---------------------------------------------------------

    def add(self, vectors: np.ndarray) -> np.ndarray:
        """Append rows; returns their positions (shape (n,))."""
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) vectors, got {vectors.shape}")
        n = vectors.shape[0]
        if n == 0:
            return np.empty((0,), dtype=np.int64)
        if self.metric == "cosine":
            norms = np.linalg.norm(vectors, axis=1, keepdims=True)
            vectors = vectors / np.maximum(norms, 1e-12)
        start = self.size
        if self.quantized:
            with stage("index.quantize"):  # host work, on the ingest path
                codes, aux, start = self._quantize(vectors, start)
                if self.refine:
                    resid = vectors - codes.astype(np.float32) * aux[:, None]
                    res_codes, res_scales = encode_residual(resid, self.refine)
        else:
            codes = vectors
            aux = (vectors * vectors).sum(axis=1).astype(np.float32)
        if start + n > self.capacity:
            # grow to the JAX package's target (its power-of-two add block),
            # so both packages hold the same capacity after the same adds
            self._grow_to(start + _pad_pow2(n, ADD_BLOCK))
        self._put(self.emb, start, codes)
        self._put(self.sqnorm, start, aux)
        self.valid[start : start + n] = True
        if self.refine:
            self._put(self.res, start, res_codes)
            self._put(self.res_scale, start, res_scales)
        self.size = start + n
        return np.arange(start, start + n, dtype=np.int64)

    def _quantize(self, vectors: np.ndarray, start: int):
        """int8 codes and per-row scales of ``vectors`` appended at
        ``start``: the first rows fill a partial tail block at its cached
        scale; when they fall outside its range the cursor realigns to the
        next block, leaving gap rows. Returns (codes, scales, start)."""
        used = start % QUANT_BLOCK
        code_parts, scale_parts = [], []
        rest = vectors
        if used:
            head = rest[: QUANT_BLOCK - used]
            amax = float(np.abs(head).max()) if head.size else 0.0
            if self._tail_scale > 0 and amax <= 127.0 * self._tail_scale:
                code_parts.append(
                    np.clip(np.rint(head / self._tail_scale), -127, 127).astype(np.int8)
                )
                scale_parts.append(np.full(len(head), self._tail_scale, np.float32))
                rest = rest[len(head):]
            else:
                gap = QUANT_BLOCK - used
                self._gap_rows += gap
                start += gap
        if len(rest):
            c, s = quantize_rows_blocked(rest, QUANT_BLOCK)
            code_parts.append(c[: len(rest)])
            scale_parts.append(s[: len(rest)])
            self._tail_scale = float(s[len(rest) - 1])
        return np.concatenate(code_parts), np.concatenate(scale_parts), start

    def mark_deleted(self, positions: np.ndarray) -> None:
        """Tombstone rows: clear their valid bits AND zero their vectors,
        so dead rows score exactly 0 under cosine/ip. With a residual
        sidecar its scale dies with the row, or the refined rescore would
        give the row a nonzero score. Deleting a row twice counts once."""
        positions = np.unique(np.asarray(positions, dtype=np.int64))
        if positions.size == 0:
            return
        idx = torch.from_numpy(positions).to(self.device)
        was_valid = int(self.valid[idx].sum())
        self.valid[idx] = False
        self.emb[idx] = 0
        if self.refine:
            self.res_scale[idx] = 0.0
        self.n_deleted += was_valid

    def restore_rows(
        self,
        rows: np.ndarray,
        aux: np.ndarray,
        valid: np.ndarray,
        n_deleted: int = 0,
        gap_rows: int = 0,
        res: Optional[np.ndarray] = None,
        res_scale: Optional[np.ndarray] = None,
        refine: Optional[str] = None,
    ) -> None:
        """Place snapshot rows directly (no re-quantization): ``rows`` are
        stored values (int8 codes in quantized mode), ``aux`` the sqnorm /
        scale column, ``valid`` the per-row liveness. The index adopts the
        snapshot's residual mode: residual codes cannot be recomputed from
        the primary codes, so a snapshot without them restores with
        refinement off. Requires an empty index."""
        size = int(len(rows))
        if size == 0:
            return
        if self.size or self.n_deleted:
            raise ValueError(
                "restore_rows requires an empty index; this one holds "
                f"{self.size} rows"
            )
        want_refine = refine if (self.quantized and res is not None) else None
        if want_refine != self.refine:
            self.refine = want_refine
            self._alloc_res(self.capacity)
        self._grow_to(_round_up(size, ADD_BLOCK))
        self._put(self.emb, 0, np.asarray(rows))
        self._put(self.sqnorm, 0, np.asarray(aux, dtype=np.float32))
        self._put(self.valid, 0, np.asarray(valid, dtype=bool))
        if self.refine:
            self._put(self.res, 0, np.asarray(res))
            self._put(self.res_scale, 0, np.asarray(res_scale, dtype=np.float32))
        self.size = size
        self.n_deleted = int(n_deleted)
        self._gap_rows = int(gap_rows)
        # rows always follow a realignment gap, so the row at size-1
        # carries the (partial) tail block's scale
        if self.quantized and size % QUANT_BLOCK:
            self._tail_scale = float(np.asarray(aux)[size - 1])
        else:
            self._tail_scale = 0.0

    def _host_rows(self) -> np.ndarray:
        """The first ``size`` rows as host f32: int8 codes · scale, plus
        the decoded residual when refinement is on."""
        n = self.size
        rows = self.emb[:n].float().cpu().numpy()
        if self.quantized:
            rows = rows * self.sqnorm[:n].cpu().numpy()[:, None]
            if self.refine:
                res = decode_residual_np(self.res[:n].cpu().numpy(), self.refine)
                rows = rows + res * self.res_scale[:n].cpu().numpy()[:, None]
        return rows

    def compact(self) -> Dict[int, int]:
        """Drop tombstoned rows; returns the old→new position mapping.
        Survivors are re-added through :meth:`add` from their best
        reconstruction (int8 rows re-quantize from codes·scale +
        residual)."""
        valid = self.valid[: self.size].cpu().numpy()
        emb = self._host_rows()
        keep = np.nonzero(valid)[0]
        mapping = {int(old): new for new, old in enumerate(keep)}
        self.size = 0
        self.n_deleted = 0
        self._gap_rows = 0
        self._tail_scale = 0.0
        self._alloc(self.capacity)
        if keep.size:
            self.add(emb[keep])
        return mapping

    # -- query ------------------------------------------------------------

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Batched exact top-k: (scores (B, k), positions (B, k)). Slots
        with no valid match carry score -inf and position -1."""
        return self.search_dispatch(queries, k)()

    def search_dispatch(
        self, queries: np.ndarray, k: int
    ) -> Callable[[], Tuple[np.ndarray, np.ndarray]]:
        """Enqueue a search on the device; the returned callable does the
        one readback and the host normalization."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if queries.shape[1] != self.dim:
            raise ValueError(f"query dim {queries.shape[1]} != index dim {self.dim}")
        k = int(k)
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        k_eff = min(k, self.capacity)
        b = queries.shape[0]
        s_dev, p_dev = self.search_device(torch.from_numpy(queries).to(self.device), k_eff)
        readback = pair_readback(s_dev, p_dev)

        def fetch() -> Tuple[np.ndarray, np.ndarray]:
            return normalize_raw(*readback(), b, k, k_eff)

        return fetch

    def _two_level(self, b: int) -> bool:
        return self._force_two_level or 4 * b * self.capacity > self.SCORE_BYTES_BUDGET

    def search_device(self, q: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-to-device search: ``q`` is a (B, dim) tensor on the
        index's device and the results stay there. Empty slots carry -inf
        (direct path) or NEG (two-level path) at position -1 or a masked
        position; the host boundary normalizes both."""
        if self.quantized:
            kf = self._kf(k)
            if self.device.type == "cuda" or self._two_level(q.shape[0]):
                s, p = two_level_topk_i8(
                    q, self.emb, self.sqnorm, self.valid, kf,
                    g=self.SUBTILE_G, block_scales=True,
                )
            else:
                s, p = _i8_topk_direct(q, self.emb, self.sqnorm, self.valid, kf)
            if kf > k:
                s, p = self.rescore_candidates(q, s, p, k)
            return self._ip_unscale(q, s), p
        if not self._two_level(q.shape[0]):
            return masked_topk(q, self.emb, self.valid, k, self.metric, self.sqnorm)
        return two_level_topk(
            q, self.emb, self.valid, k, g=self.SUBTILE_G, metric=self.metric,
            sqnorm=self.sqnorm,
        )

    def _kf(self, k: int) -> int:
        """Candidate over-fetch of the quantized search (``kf_mult``·k with
        a floor), or k when nothing rescores the candidates."""
        if self.quantized and (self.rescore_i8 or self.refine):
            return min(max(self.kf_mult * k, 8 * self.kf_mult), self.capacity)
        return k

    def rescore_candidates(
        self, q: torch.Tensor, s: torch.Tensor, p: torch.Tensor, k: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Rescore int8 candidates (scores ``s``, positions ``p``, (B, kf))
        with the normalized f32 query against their dequantized rows, plus
        the residual when refinement is on, and keep the top k. Empty
        candidates score -inf."""
        qn = normalize_rows(q)[:, :, None]
        safe = torch.clamp(p, min=0)
        codes, scale = self.emb[safe].float(), self.sqnorm[safe]
        if self.refine:
            rows = codes * scale[..., None] + decode_residual(
                self.res[safe], self.refine
            ) * self.res_scale[safe][..., None]
            exact = torch.bmm(rows, qn)[:, :, 0]
        else:
            exact = torch.bmm(codes, qn)[:, :, 0] * scale
        exact = torch.where((p >= 0) & (s > NEG_INF), exact, NEG_INF)
        s2, sel = stable_topk(exact, k)
        return s2, torch.gather(p, 1, sel)

    def _ip_unscale(self, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """The int8 pipeline scores with a NORMALIZED query; for
        metric='ip' the absolute scores are q·x, so multiply back by ‖q‖
        at the end (ranking-invariant per query)."""
        if self.metric != "ip":
            return s
        return s * row_norm(q)

    def take(self, positions: np.ndarray) -> np.ndarray:
        """Vectors at positions, as host f32. int8 rows dequantize through
        their scale (and residual)."""
        idx = torch.from_numpy(np.asarray(positions, dtype=np.int64)).to(self.device)
        out = self.emb[idx].float().cpu().numpy()
        if self.quantized:
            out = out * self.sqnorm[idx].cpu().numpy()[:, None]
            if self.refine:
                res = decode_residual_np(self.res[idx].cpu().numpy(), self.refine)
                out = out + res * self.res_scale[idx].cpu().numpy()[:, None]
        return out

    # -- introspection ----------------------------------------------------

    @property
    def n_active(self) -> int:
        return self.size - self.n_deleted - self._gap_rows

    def stats(self) -> Dict[str, object]:
        res_bytes = self.capacity * (self.res.shape[1] + 4) if self.refine else 0
        return {
            "kind": "flat",
            "dim": self.dim,
            "metric": self.metric,
            "capacity": self.capacity,
            "size": self.size,
            "active": self.n_active,
            "deleted": self.n_deleted,
            "dtype": str(self.dtype).removeprefix("torch."),
            "gap_rows": self._gap_rows,
            "shards": 1,
            "refine": self.refine,
            # the JAX package's name for the stored vectors' device bytes
            "hbm_bytes": self.capacity * self.dim * self.emb.element_size() + res_bytes,
            "device": str(self.device),
        }
