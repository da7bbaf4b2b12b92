"""Device-resident flat (exact) vector index (counterpart of
``rag_arc_tpu/index/flat.py::DeviceFlatIndex``, bf16/f32 path).

- The corpus is a capacity-padded tensor ``emb (capacity, dim)`` with a
  ``valid (capacity,)`` tombstone mask and an ``sqnorm`` cache for the l2
  metric. Capacity grows by doubling, in ``ADD_BLOCK`` multiples.
- Deletes clear the mask bit and zero the row, so dead rows score 0
  under cosine/ip and snapshots stay interchangeable with the JAX
  package's.
- Search: a score matrix within ``SCORE_BYTES_BUDGET`` takes the direct
  product + top-k; a larger one takes the two-level path, whose sub-tile
  max is the CUDA kernel on the card. The two-level producer is masked,
  so it is exact without the TPU path's certificate.

Tensors are updated in place (the JAX package rebuilt donated buffers).
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from rag_arc_tpu_torch.ops.topk import masked_topk

logger = logging.getLogger(__name__)

ADD_BLOCK = 1024  # capacity granularity


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


class DeviceFlatIndex:
    """Exact MIPS/L2/cosine index over device-resident vectors."""

    # direct-path budget for the (B, N) f32 score matrix; above it the
    # search takes the two-level path
    SCORE_BYTES_BUDGET = 1 << 30

    # rows per pass-1 sub-tile max (the kernel's g)
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
    ):
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"dtype {dtype} is not ported yet: f32 and bf16 only "
                "(ROADMAP Queue 1 #8, the int8 flat index)"
            )
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
        self.capacity = _round_up(max(capacity, ADD_BLOCK), ADD_BLOCK)
        self.size = 0  # high-water mark of written rows
        self.n_deleted = 0
        self._alloc(self.capacity)

    def _alloc(self, capacity: int) -> None:
        self.emb = torch.zeros((capacity, self.dim), dtype=self.dtype, device=self.device)
        self.valid = torch.zeros((capacity,), dtype=torch.bool, device=self.device)
        self.sqnorm = torch.zeros((capacity,), dtype=torch.float32, device=self.device)

    def _grow_to(self, min_capacity: int) -> None:
        new_cap = self.capacity
        while new_cap < min_capacity:
            new_cap *= 2
        new_cap = _round_up(new_cap, ADD_BLOCK)
        if new_cap == self.capacity:
            return
        logger.info("growing index capacity %d → %d", self.capacity, new_cap)
        old = (self.emb, self.valid, self.sqnorm)
        self.capacity = new_cap
        self._alloc(new_cap)
        for new, prev in zip((self.emb, self.valid, self.sqnorm), old):
            new[: prev.shape[0]] = prev

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
        if start + n > self.capacity:
            # grow to the JAX package's target (its power-of-two add block),
            # so both packages hold the same capacity after the same adds
            self._grow_to(start + _pad_pow2(n, ADD_BLOCK))
        block = torch.from_numpy(vectors).to(self.device)
        self.emb[start : start + n] = block.to(self.dtype)
        self.sqnorm[start : start + n] = (block * block).sum(dim=1)
        self.valid[start : start + n] = True
        self.size = start + n
        return np.arange(start, start + n, dtype=np.int64)

    def mark_deleted(self, positions: np.ndarray) -> None:
        """Tombstone rows: clear their valid bits AND zero their vectors,
        so dead rows score exactly 0 under cosine/ip. Deleting a row twice
        counts once."""
        positions = np.unique(np.asarray(positions, dtype=np.int64))
        if positions.size == 0:
            return
        idx = torch.from_numpy(positions).to(self.device)
        was_valid = int(self.valid[idx].sum())
        self.valid[idx] = False
        self.emb[idx] = 0
        self.n_deleted += was_valid

    def compact(self) -> Dict[int, int]:
        """Drop tombstoned rows; returns the old→new position mapping.
        Survivors are re-added through :meth:`add`."""
        valid = self.valid[: self.size].cpu().numpy()
        emb = self.emb[: self.size].float().cpu().numpy()
        keep = np.nonzero(valid)[0]
        mapping = {int(old): new for new, old in enumerate(keep)}
        self.size = 0
        self.n_deleted = 0
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

        def fetch() -> Tuple[np.ndarray, np.ndarray]:
            return normalize_raw(*fetch_pair(s_dev, p_dev), b, k, k_eff)

        return fetch

    def search_device(self, q: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-to-device search: ``q`` is a (B, dim) tensor on the
        index's device and the results stay there. Empty slots carry -inf
        (direct path) or NEG (two-level path) at position -1 or a masked
        position; the host boundary normalizes both."""
        score_bytes = 4 * q.shape[0] * self.capacity
        if score_bytes <= self.SCORE_BYTES_BUDGET and not self._force_two_level:
            return masked_topk(q, self.emb, self.valid, k, self.metric, self.sqnorm)
        from rag_arc_tpu_torch.ops.two_level import two_level_topk

        return two_level_topk(
            q, self.emb, self.valid, k, g=self.SUBTILE_G, metric=self.metric
        )

    def take(self, positions: np.ndarray) -> np.ndarray:
        """Vectors at positions, as host f32."""
        idx = torch.from_numpy(np.asarray(positions, dtype=np.int64)).to(self.device)
        return self.emb[idx].float().cpu().numpy()

    # -- introspection ----------------------------------------------------

    @property
    def n_active(self) -> int:
        return self.size - self.n_deleted

    def stats(self) -> Dict[str, object]:
        return {
            "kind": "flat",
            "dim": self.dim,
            "metric": self.metric,
            "capacity": self.capacity,
            "size": self.size,
            "active": self.n_active,
            "deleted": self.n_deleted,
            "dtype": str(self.dtype).removeprefix("torch."),
            "device": str(self.device),
            "device_bytes": self.capacity * self.dim * self.emb.element_size(),
        }
