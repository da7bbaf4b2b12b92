"""Device-resident IVF (inverted-file) index (counterpart of
``rag_arc_tpu/index/ivf.py::DeviceIVFIndex``).

Layout: the cluster lists are a padded dense tensor ``lists (nlist, Lmax,
dim)`` with a validity mask, an f32 ``sqnorm`` column (squared norms, or
the int8 rows' scales) and a global-position tensor. A search is

  centroid scores (B, nlist) → top-nprobe lists → ``ops/ivf_scan``
  (B, nprobe·Lmax) masked scores → exact top-k (``ops/bm25.py::
  select_topk``) → positions.

On the card the scan is the hand-written kernel ``csrc/ivf_scan.cu``,
which reads each probed list where it lies, and the top-k is the select
kernel ``csrc/subtile_select.cu``: one launch of each a sub-batch. The
score buffer is the only thing a search materializes, so the sub-batch
is bounded by its bytes (``SCORE_BUDGET_BYTES``). A CPU index takes the
kernels' plain versions, sub-batched by the JAX package's gather budget.
The score buffer's width is padded with -inf to a multiple of 512, so the
select takes its group path.

int8 mode stores residuals (row − assigned centroid) as per-row scaled
int8 codes; scoring adds the exact f32 centroid product back. Spilled
assignment (``spill`` 2..4) stores a row in its ``spill`` nearest lists
and the search dedupes positions over a spill·k window. Build and slot
bookkeeping (``_pack_by_cluster``, ``_record_locs``) are host numpy,
copied from the JAX package; the lists are filled on the device. Tensors
are updated in place (the JAX package rebuilt donated buffers).

Recall follows nprobe/nlist and the data's cluster structure, exactly as
in FAISS; ``index_type="auto"`` stays flat (see the JAX package's note).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from rag_arc_tpu_torch.index.flat import fetch_pair
from rag_arc_tpu_torch.ops.bm25 import _coarse_topk, _iter_topk, full_f32_matmul, select_topk
from rag_arc_tpu_torch.ops.ivf_scan import ivf_scan, ivf_scan_plain
from rag_arc_tpu_torch.ops.kmeans import kmeans
from rag_arc_tpu_torch.ops.scoring import NEG_INF, l2_normalize
from rag_arc_tpu_torch.ops.topk import stable_topk
from rag_arc_tpu_torch.ops.two_level import quantize_rows

logger = logging.getLogger(__name__)

SUB_BATCH = 32  # CPU: max query sub-batch per dispatch, as the JAX package
GATHER_BUDGET_BYTES = 1 << 30  # CPU: cap on the plain version's probe gather
SCORE_BUDGET_BYTES = 1 << 30  # card: cap on the (B, nprobe·Lmax) f32 score buffer
SELECT_PAD = 512  # score-buffer width multiple: the select's widest group
UPLOAD_ROWS = 1 << 18  # rows placed into the lists per device step

_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class DeviceIVFIndex:
    def __init__(
        self,
        dim: int,
        nlist: int = 100,
        nprobe: int = 8,
        metric: str = "cosine",
        dtype: torch.dtype = torch.float32,
        mesh: Optional[object] = None,
        spill: int = 1,
        spill_cap: float = 1.25,
        *,
        device: torch.device | str,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "sharded IVF indexes are not ported yet (ROADMAP Queue 1 [#15])"
            )
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {_DTYPES}, got {dtype}")
        if metric not in ("cosine", "ip", "l2"):
            raise ValueError(f"unknown metric {metric!r}")
        self.dim = dim
        # spilled assignment: each row is stored in its ``spill`` nearest
        # lists, so a query whose perturbation flips the centroid ranking
        # still probes a list holding the neighbor (×spill list memory)
        if not 1 <= int(spill) <= 4:
            raise ValueError("spill must be 1..4")
        self.spill = int(spill)
        # bulk-build bound on any ONE list's length, as a multiple of the
        # mean (spill·n/nlist); primary copies are never dropped
        self.spill_cap = float(spill_cap)
        self.mesh = None
        # int8 mode stores RESIDUALS (row − assigned centroid) as per-row
        # scaled int8; scoring adds the exact centroid dot back
        self.quantized = dtype == torch.int8
        if self.quantized and metric == "l2":
            raise ValueError("int8 IVF storage supports cosine/ip, not l2")
        self.n_shards = 1
        self.nlist = nlist
        self.nlist_pad = nlist
        self.nprobe = min(nprobe, nlist)
        self.metric = metric
        self.dtype = dtype
        self.device = torch.device(device)
        self.size = 0
        self.n_deleted = 0
        self.lmax = 0
        self.centroids: Optional[torch.Tensor] = None
        self.lists: Optional[torch.Tensor] = None
        self.sqnorm: Optional[torch.Tensor] = None
        self.valid: Optional[torch.Tensor] = None
        self.pos: Optional[torch.Tensor] = None
        self.cluster_valid: Optional[torch.Tensor] = None
        # seconds of the last bulk build: k-means, spill assignment,
        # packing (host), upload (device fill)
        self.build_seconds: Dict[str, float] = {}
        # host-side slot bookkeeping: per-cluster fill counts plus flat
        # arrays mapping global position -> (cluster, slot)
        self._fill = np.zeros(nlist, dtype=np.int64)
        self._pos_cluster = np.empty(0, dtype=np.int32)
        self._pos_slot = np.empty(0, dtype=np.int32)
        # spill copies 2..spill: (n, spill-1) maps, same indexing
        self._pos_xcluster = np.empty((0, self.spill - 1), dtype=np.int32)
        self._pos_xslot = np.empty((0, self.spill - 1), dtype=np.int32)
        # host mirror of tombstoned positions: keeps n_deleted exact under
        # duplicate/repeated deletes
        self._deleted_pos: set = set()

    def _tensor(self, a, dtype: torch.dtype) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, dtype)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, dtype)

    def _place(self, lists, sqnorm, valid, pos, centroids, cluster_valid):
        """Device placement of the index arrays (numpy or tensors)."""
        self.lists = self._tensor(lists, self.dtype)
        self.sqnorm = self._tensor(sqnorm, torch.float32)
        self.valid = self._tensor(valid, torch.bool)
        self.pos = self._tensor(pos, torch.int32)
        self.centroids = self._tensor(centroids, torch.float32)
        self.cluster_valid = self._tensor(cluster_valid, torch.bool)

    # -- build -------------------------------------------------------------

    @classmethod
    def from_vectors(
        cls,
        vectors: np.ndarray,
        nlist: int = 100,
        nprobe: int = 8,
        metric: str = "cosine",
        dtype: torch.dtype = torch.float32,
        train_iters: int = 10,
        seed: int = 0,
        mesh: Optional[object] = None,
        spill: int = 1,
        spill_cap: float = 1.25,
        *,
        device: torch.device | str,
    ) -> "DeviceIVFIndex":
        vectors = np.asarray(vectors, dtype=np.float32)
        index = cls(
            dim=vectors.shape[1], nlist=nlist, nprobe=nprobe, metric=metric,
            dtype=dtype, mesh=mesh, spill=spill, spill_cap=spill_cap, device=device,
        )
        index._train_and_fill(vectors, train_iters, seed)
        return index

    def _assign_spill(self, vectors: np.ndarray, chunk: int = 1 << 17) -> np.ndarray:
        """(n, spill) nearest-centroid assignments, score-descending (column
        0 = the primary copy, ties to the lowest centroid), on the device in
        true f32."""
        c = torch.from_numpy(self._centroids_np).to(self.device)
        c_sq = torch.sum(c * c, dim=1)
        out = []
        with full_f32_matmul():
            for s0 in range(0, len(vectors), chunk):
                v = torch.from_numpy(np.ascontiguousarray(vectors[s0 : s0 + chunk]))
                scores = v.to(self.device) @ c.T
                if self.metric == "l2":
                    scores = 2.0 * scores - c_sq[None, :]
                out.append(stable_topk(scores, self.spill)[1])
        return torch.cat(out).cpu().numpy().astype(np.int64)

    def _prep(self, vectors: np.ndarray) -> np.ndarray:
        vectors = np.asarray(vectors, dtype=np.float32)
        if self.metric == "cosine":
            vectors = vectors / np.maximum(
                np.linalg.norm(vectors, axis=1, keepdims=True), 1e-12
            )
        return vectors

    @staticmethod
    def _quantize_residuals(vectors, assigned_centroids):
        """Per-row symmetric int8 over residuals (row − its centroid)."""
        return quantize_rows(vectors - assigned_centroids)

    @staticmethod
    def _pack_by_cluster(
        assign: np.ndarray, base_fill: np.ndarray, nlist: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized slot assignment: for each row, its cluster and the
        slot it lands in (base_fill[c] + within-batch rank). Returns
        (order, clusters_sorted, slots_sorted) where ``order`` sorts rows
        by cluster."""
        order = np.argsort(assign, kind="stable")
        sa = assign[order].astype(np.int64)
        first = np.searchsorted(sa, np.arange(nlist))
        slots = np.arange(len(sa), dtype=np.int64) - first[sa] + base_fill[sa]
        return order, sa, slots

    def _record_locs(self, order, clusters_sorted, slots_sorted, n: int) -> None:
        """Append position->(cluster, slot) entries for n new rows. With
        spill the packed entries are copy-major (first n entries = primary
        copies, next n = second copies, …). Spill copies dropped by the
        spill_cap never appear in ``order`` and stay -1."""
        total = n * self.spill
        pcf = np.full(total, -1, dtype=np.int32)
        psf = np.full(total, -1, dtype=np.int32)
        pcf[order] = clusters_sorted.astype(np.int32)
        psf[order] = slots_sorted.astype(np.int32)
        pc = pcf.reshape(self.spill, n).T  # (n, spill)
        ps = psf.reshape(self.spill, n).T
        self._pos_cluster = np.concatenate([self._pos_cluster, pc[:, 0]])
        self._pos_slot = np.concatenate([self._pos_slot, ps[:, 0]])
        if self.spill > 1:
            self._pos_xcluster = np.concatenate([self._pos_xcluster, pc[:, 1:]])
            self._pos_xslot = np.concatenate([self._pos_xslot, ps[:, 1:]])

    def _spill_keep(self, order, slots, n_rows: int, n: int) -> np.ndarray:
        """Entries kept under the per-list cap (spill_cap × the mean list
        length over ``n_rows`` rows); primaries (flat entry < n) always."""
        cap = max(int(np.ceil(self.spill * n_rows / self.nlist * self.spill_cap)), 8)
        return (slots < cap) | (order < n)

    def _fill_rows(self, rows, aux, clusters, slots, positions) -> None:
        """Scatter rows into their (cluster, slot) cells in place, in
        device steps of ``UPLOAD_ROWS``. ``rows`` is a host array or a
        device tensor; the cast to the index dtype happens on the device
        (round to nearest even, as numpy's bf16 cast)."""
        for s0 in range(0, len(slots), UPLOAD_ROWS):
            part = slice(s0, s0 + UPLOAD_ROWS)
            cl = torch.from_numpy(clusters[part]).to(self.device)
            sl = torch.from_numpy(slots[part]).to(self.device)
            self.lists[cl, sl] = self._tensor(rows[part], self.dtype)
            self.sqnorm[cl, sl] = self._tensor(aux[part], torch.float32)
            self.valid[cl, sl] = True
            self.pos[cl, sl] = self._tensor(positions[part], torch.int32)

    def _train_and_fill(self, vectors: np.ndarray, train_iters: int, seed: int) -> None:
        t0 = time.perf_counter()
        vectors = self._prep(vectors)
        n = vectors.shape[0]
        if n < self.nlist:
            raise ValueError(
                f"IVF needs >= nlist ({self.nlist}) training vectors, got {n}"
            )
        centroids, assign = kmeans(
            vectors, self.nlist, n_iters=train_iters, seed=seed, device=self.device
        )
        self._centroids_np = centroids  # true-nlist copy for add() assignment
        t1 = time.perf_counter()
        if self.spill > 1:
            assign_mat = self._assign_spill(vectors)  # (n, spill)
        else:
            assign_mat = assign.astype(np.int64)[:, None]
        t2 = time.perf_counter()
        # copy-major flat layout: entry i + c·n is copy c of row i
        flat_assign = assign_mat.T.reshape(-1)
        rows_idx = np.tile(np.arange(n, dtype=np.int64), self.spill)
        order, sa, slots = self._pack_by_cluster(
            flat_assign, np.zeros(self.nlist, dtype=np.int64), self.nlist
        )
        if self.spill > 1:
            # the stable sort puts primaries in the lowest slots of every
            # list, so dropping slots >= cap sheds only spill copies
            keep = self._spill_keep(order, slots, n, n)
            if not keep.all():
                order, sa, slots = order[keep], sa[keep], slots[keep]
        # per-list fill = max kept slot + 1; lmax with 1.25x add headroom
        fill = np.zeros(self.nlist, dtype=np.int64)
        np.maximum.at(fill, sa, slots + 1)
        self.lmax = _round_up(max(int(slots.max()) + 1, 8) * 5 // 4, 8)
        src = rows_idx[order]
        t3 = time.perf_counter()
        shape = (self.nlist_pad, self.lmax)
        centroids_pad = np.zeros((self.nlist_pad, self.dim), dtype=np.float32)
        centroids_pad[: self.nlist] = centroids
        cluster_valid = np.zeros(self.nlist_pad, dtype=bool)
        cluster_valid[: self.nlist] = True
        # the lists are filled on the device: a host staging array in the
        # index dtype would need bf16 in numpy
        self._place(
            torch.zeros((*shape, self.dim), dtype=self.dtype, device=self.device),
            torch.zeros(shape, dtype=torch.float32, device=self.device),
            torch.zeros(shape, dtype=torch.bool, device=self.device),
            torch.full(shape, -1, dtype=torch.int32, device=self.device),
            centroids_pad, cluster_valid,
        )
        if self.quantized:
            # residual codes, quantized on the host a step at a time
            for s0 in range(0, len(src), UPLOAD_ROWS):
                part = slice(s0, s0 + UPLOAD_ROWS)
                codes, scales = self._quantize_residuals(vectors[src[part]],
                                                         centroids[sa[part]])
                self._fill_rows(codes, scales, sa[part], slots[part], src[part])
        else:
            # upload the rows once; each copy is gathered on the device
            sq = (vectors * vectors).sum(axis=1)
            vdev = torch.from_numpy(vectors).to(self.device)
            for s0 in range(0, len(src), UPLOAD_ROWS):
                part = slice(s0, s0 + UPLOAD_ROWS)
                self._fill_rows(vdev[torch.from_numpy(src[part]).to(self.device)],
                                sq[src[part]], sa[part], slots[part], src[part])
            del vdev
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t4 = time.perf_counter()
        # packing is the host slot assignment; upload the device fill (with
        # int8 residual quantization on the host)
        self.build_seconds = {"kmeans": t1 - t0, "assign": t2 - t1,
                              "pack": t3 - t2, "upload": t4 - t3}
        self._fill = fill
        self._pos_cluster = np.empty(0, dtype=np.int32)
        self._pos_slot = np.empty(0, dtype=np.int32)
        self._pos_xcluster = np.empty((0, self.spill - 1), dtype=np.int32)
        self._pos_xslot = np.empty((0, self.spill - 1), dtype=np.int32)
        self._record_locs(order, sa, slots, n)
        self.size = n

    # -- mutation ------------------------------------------------------------

    def add(self, vectors: np.ndarray) -> np.ndarray:
        """Append rows: one in-place scatter into their (cluster, slot)
        cells; the slot axis grows on the device when a list fills."""
        if self.centroids is None:
            raise RuntimeError("IVF index is untrained; build with from_vectors")
        vectors = self._prep(vectors)
        n = vectors.shape[0]
        if n == 0:
            return np.empty((0,), dtype=np.int64)
        c = self._centroids_np
        assign_mat = self._assign_spill(vectors)  # (n, spill)
        flat_assign = assign_mat.T.reshape(-1)
        rows_idx = np.tile(np.arange(n, dtype=np.int64), self.spill)
        order, sa, slots = self._pack_by_cluster(flat_assign, self._fill, self.nlist)
        if self.spill > 1:
            # the bulk build's cap, or compact() (which re-adds everything)
            # would regrow lmax to the uncapped skewed worst case
            keep = self._spill_keep(order, slots, self.size + n, n)
            if not keep.all():
                order, sa, slots = order[keep], sa[keep], slots[keep]
        while int(slots.max()) + 1 > self.lmax:
            self._grow_lmax()
        positions = np.arange(self.size, self.size + n, dtype=np.int64)
        sorted_vecs = vectors[rows_idx[order]]
        if self.quantized:
            rows, aux = self._quantize_residuals(sorted_vecs, c[sa])
        else:
            rows = sorted_vecs
            aux = (sorted_vecs * sorted_vecs).sum(axis=1).astype(np.float32)
        self._fill_rows(rows, aux, sa, slots, positions[rows_idx[order]])
        self._record_locs(order, sa, slots, n)
        np.maximum.at(self._fill, sa, slots + 1)
        self.size += n
        return positions

    def _grow_lmax(self) -> None:
        """Double the slot axis on the device (new slots empty)."""
        new_lmax = self.lmax * 2
        logger.info("growing IVF list capacity %d → %d", self.lmax, new_lmax)

        def grown(a: torch.Tensor, fill) -> torch.Tensor:
            out = torch.full((a.shape[0], new_lmax, *a.shape[2:]), fill, dtype=a.dtype,
                             device=a.device)
            out[:, : self.lmax] = a
            return out

        self.lists = grown(self.lists, 0)
        self.sqnorm = grown(self.sqnorm, 0.0)
        self.valid = grown(self.valid, False)
        self.pos = grown(self.pos, -1)
        self.lmax = new_lmax

    def compact(self) -> Dict[int, int]:
        """Drop tombstoned rows by re-packing the live vectors into fresh
        lists (keeping the trained centroids); returns the old→new position
        mapping for the docstore remap."""
        valid = self.valid.cpu().numpy()
        pos = self.pos.cpu().numpy()
        mask = valid & (pos >= 0)
        cl, sl = np.nonzero(mask)
        old_pos = pos[cl, sl]
        order = np.argsort(old_pos, kind="stable")
        old_sorted = old_pos[order]
        if self.spill > 1:
            # every live row appears once per spill copy — keep ONE (the
            # re-add below re-spills it)
            keep = np.ones(len(old_sorted), dtype=bool)
            keep[1:] = old_sorted[1:] != old_sorted[:-1]
            order = order[keep]
            old_sorted = old_sorted[keep]
        cl_o = torch.from_numpy(cl[order]).to(self.device)
        sl_o = torch.from_numpy(sl[order]).to(self.device)
        vectors = self.lists[cl_o, sl_o].float().cpu().numpy()
        if self.quantized:
            # centroid + dequantized residual (re-added against the same
            # centroids, so it re-quantizes)
            scales = self.sqnorm[cl_o, sl_o].cpu().numpy()
            vectors = self._centroids_np[cl[order]] + vectors * scales[:, None]
        mapping = {int(old): new for new, old in enumerate(old_sorted)}
        self.size = 0
        self.n_deleted = 0
        self._deleted_pos.clear()
        self._fill = np.zeros(self.nlist, dtype=np.int64)
        self._pos_cluster = np.empty(0, dtype=np.int32)
        self._pos_slot = np.empty(0, dtype=np.int32)
        self._pos_xcluster = np.empty((0, self.spill - 1), dtype=np.int32)
        self._pos_xslot = np.empty((0, self.spill - 1), dtype=np.int32)
        self.lists.zero_()
        self.sqnorm.zero_()
        self.valid.zero_()
        self.pos.fill_(-1)
        if len(vectors):
            self.add(vectors)
        return mapping

    def mark_deleted(self, positions: np.ndarray) -> None:
        positions = np.asarray(positions, dtype=np.int64)
        positions = np.unique(positions[(positions >= 0) & (positions < self.size)])
        positions = np.asarray(
            [p for p in positions if int(p) not in self._deleted_pos],
            dtype=positions.dtype,
        )
        if positions.size == 0:
            return
        self._deleted_pos.update(int(p) for p in positions)
        clusters = self._pos_cluster[positions]
        slots = self._pos_slot[positions]
        if self.spill > 1:
            # every spill copy dies with the row
            clusters = np.concatenate([clusters, self._pos_xcluster[positions].reshape(-1)])
            slots = np.concatenate([slots, self._pos_xslot[positions].reshape(-1)])
            live = clusters >= 0  # -1 = spill copy dropped by spill_cap
            clusters, slots = clusters[live], slots[live]
        self.valid[
            torch.from_numpy(clusters.astype(np.int64)).to(self.device),
            torch.from_numpy(slots.astype(np.int64)).to(self.device),
        ] = False
        self.n_deleted += int(positions.size)

    # -- search --------------------------------------------------------------

    def _sub_batch(self, nprobe: int) -> int:
        """Queries a dispatch: on the card, bounded by the score buffer's
        bytes; on the CPU, by the JAX package's gather budget."""
        if self.device.type == "cuda":
            per_q = 4 * _round_up(nprobe * self.lmax, SELECT_PAD)
            return max(1, SCORE_BUDGET_BYTES // per_q)
        per_q = nprobe * self.lmax * self.dim * self.lists.element_size()
        return max(1, min(SUB_BATCH, GATHER_BUDGET_BYTES // max(per_q, 1)))

    def search(
        self, queries: np.ndarray, k: int, nprobe: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        if self.centroids is None or self.size == 0:
            b = np.atleast_2d(queries).shape[0]
            return (
                np.full((b, k), -np.inf, dtype=np.float32),
                np.full((b, k), -1, dtype=np.int64),
            )
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if queries.shape[1] != self.dim:
            raise ValueError(f"query dim {queries.shape[1]} != {self.dim}")
        if k <= 0:
            raise ValueError("k must be positive")
        nprobe = min(nprobe or self.nprobe, self.nlist)
        k_eff = min(k, nprobe * self.lmax)
        sub_batch = self._sub_batch(nprobe)
        parts = []
        for start in range(0, queries.shape[0], sub_batch):
            q = torch.from_numpy(queries[start : start + sub_batch]).to(self.device)
            parts.append(self.search_sub(q, k_eff, nprobe))
        scores, positions = fetch_pair(
            torch.cat([s for s, _ in parts]), torch.cat([p for _, p in parts])
        )
        positions = np.where(np.isneginf(scores), -1, positions)
        if k_eff < k:
            scores = np.pad(scores, ((0, 0), (0, k - k_eff)), constant_values=-np.inf)
            positions = np.pad(positions, ((0, 0), (0, k - k_eff)), constant_values=-1)
        return scores, positions

    def search_sub(
        self, q: torch.Tensor, k: int, nprobe: int, plain: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One dispatch on the device: ``q (B, dim)`` f32 on the index's
        device, 1 ≤ k ≤ nprobe·Lmax. Returns (scores (B, k), positions
        (B, k)), -inf at position -1 for empty slots. ``plain`` takes the
        kernels' plain versions (``ivf_scan_plain`` and the select's
        tournament) on any device: the all-plain pipeline the kernel path
        is held to."""
        nprobe = min(nprobe, self.nlist)
        if self.metric == "cosine":
            q = l2_normalize(q)
        # a true f32 product: in int8 mode q·c is the DOMINANT score term,
        # and for every mode it ranks the lists as the JAX package does
        with full_f32_matmul():
            cross = q @ self.centroids.T
        if self.metric == "l2":
            c_sq = torch.sum(self.centroids * self.centroids, dim=1)
            c_scores = 2.0 * cross - c_sq[None, :]
        else:
            c_scores = cross
        c_scores = torch.where(self.cluster_valid[None, :], c_scores, NEG_INF)
        _, probe = stable_topk(c_scores, nprobe)  # (B, nprobe)
        b, n = q.shape[0], nprobe * self.lmax
        scores = torch.full((b, _round_up(n, SELECT_PAD)), NEG_INF, dtype=torch.float32,
                            device=q.device)
        args = (q, probe, self.lists, self.sqnorm, self.valid, self.metric,
                cross if self.quantized else None)
        if plain:
            scores[:, :n] = ivf_scan_plain(*args)
        else:
            ivf_scan(*args, out=scores[:, :n])
        # the spill factor bounds each position's copies among the
        # candidates, so a spill·k window holds >= k unique positions
        kk = min(self.spill * k, n) if self.spill > 1 else k
        s, idx = (_select_plain if plain else select_topk)(scores, kk)
        idx = torch.clamp(idx, 0, n - 1)  # -inf slots: any index, masked below
        cluster = torch.gather(probe, 1, idx // self.lmax)
        p = self.pos[cluster, idx % self.lmax].long()
        p = torch.where(torch.isneginf(s), -1, p)
        if self.spill > 1:
            return _dedupe_candidates(s, p, k)
        return s, p

    def take(self, positions: np.ndarray) -> np.ndarray:
        positions = np.asarray(positions, dtype=np.int64)
        clusters = self._pos_cluster[positions]
        cl = torch.from_numpy(clusters.astype(np.int64)).to(self.device)
        sl = torch.from_numpy(self._pos_slot[positions].astype(np.int64)).to(self.device)
        out = self.lists[cl, sl].float().cpu().numpy()
        if self.quantized:
            scales = self.sqnorm[cl, sl].cpu().numpy()
            out = self._centroids_np[clusters] + out * scales[:, None]
        return out

    # -- introspection ----------------------------------------------------------

    @property
    def n_active(self) -> int:
        return self.size - self.n_deleted

    def stats(self) -> Dict[str, object]:
        fill = self._fill
        return {
            "kind": "ivf",
            "dim": self.dim,
            "metric": self.metric,
            "nlist": self.nlist,
            "nprobe": self.nprobe,
            "spill": self.spill,
            "lmax": self.lmax,
            "size": self.size,
            "active": self.n_active,
            "deleted": self.n_deleted,
            "list_fill_mean": float(fill.mean()) if self.size else 0.0,
            "list_fill_max": int(fill.max()) if self.size else 0,
            "dtype": str(self.dtype).removeprefix("torch."),
            "quantized": self.quantized,
            # the JAX package's name for the lists' device bytes
            "hbm_bytes": 0
            if self.lists is None
            else self.nlist_pad * self.lmax * self.dim * self.lists.element_size(),
            "shards": self.n_shards,
            "device": str(self.device),
        }


def _select_plain(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The select's plain version on any device: ``select_topk``'s CPU
    branch (the JAX package's tournament)."""
    for g in (512, 256, 128):
        if scores.shape[1] % g == 0 and k <= g:
            return _coarse_topk(scores, k, g)
    return _iter_topk(scores, k)


def _dedupe_candidates(s, p, k):
    """Top-k over score-descending candidates (B, K) with duplicate
    POSITIONS masked: an entry is a duplicate when an earlier (higher-
    ranked) entry carries the same non-negative position. Exact when
    callers pass a spill·k window."""
    kk = s.shape[1]
    tri = torch.tril(torch.ones((kk, kk), dtype=torch.bool, device=s.device), -1)
    dup = (p[:, :, None] == p[:, None, :]) & tri[None]
    isdup = torch.any(dup, dim=2) & (p >= 0)
    s = torch.where(isdup, NEG_INF, s)
    s2, sel = stable_topk(s, min(k, kk))
    return s2, torch.gather(p, 1, sel)
