"""Reciprocal-rank fusion over position tensors (counterpart of
``rag_arc_tpu/ops/fusion_kernel.py``).

The host ``RRFusion`` (``utils/fusion.py``) dedups by document content,
which fusing across retrievers with unrelated id spaces needs. When every
path shares one id space (multi-query fan-out over one store), fusion can
run on the (B, P, k) position tensor where it lies: RRF scores with
position-identity dedup, then the fused top-k, so the variants'
candidates never become Documents one by one.

Shapes are tiny (P·k ≤ a few hundred), so this is plain torch. The final
top-k is ``ops/topk.py::stable_topk``: ties go to the lower slot, i.e.
the first occurrence in path-major, rank-minor order, as ``lax.top_k``
gives them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rag_arc_tpu_torch.ops.topk import stable_topk


def rrf_fuse_positions(
    positions: torch.Tensor,  # (B, P, k) int candidate ids per path, -1 = empty
    k_out: int,
    rrf_k: int = 60,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse P ranked candidate lists per query into an RRF top-k_out.

    Returns (scores (B, k_out) f32, positions (B, k_out)); empty slots are
    (-inf, -1). Duplicate ids accumulate 1/(rrf_k + rank) over all their
    occurrences, rank 1-based, in f32."""
    b, p, k = positions.shape
    dev = positions.device
    flat = positions.reshape(b, p * k)  # (B, M)
    ranks = torch.arange(1, k + 1, dtype=torch.float32, device=dev).repeat(p)  # (M,)
    contrib = torch.where(flat >= 0, 1.0 / (rrf_k + ranks)[None, :], 0.0)  # (B, M)
    # pairwise identity: same[b, i, j] = flat[b, i] == flat[b, j] (valid only)
    eq = (flat[:, :, None] == flat[:, None, :]) & (flat[:, :, None] >= 0)
    # every occurrence's contribution onto each candidate slot
    scores = torch.einsum("bij,bj->bi", eq.float(), contrib)
    # keep only the first occurrence of each id
    idx = torch.arange(p * k, device=dev)
    earlier_dup = torch.any(eq & (idx[None, :, None] > idx[None, None, :]), dim=2)
    scores = torch.where((flat >= 0) & ~earlier_dup, scores, float("-inf"))
    fused_scores, sel = stable_topk(scores, k_out)
    fused_positions = torch.gather(flat, 1, sel)
    fused_positions = torch.where(torch.isneginf(fused_scores), -1, fused_positions)
    return fused_scores, fused_positions
