"""Masked top-k over scored corpora (counterpart of ``rag_arc_tpu/ops/topk.py``).

The direct path for small score matrices: score product → mask
tombstoned rows to -inf → top-k. Ties break toward the lower index, as
``lax.top_k`` does: ``torch.topk`` leaves tie order unspecified, so the
selection is a stable descending sort. Whether ``torch.topk`` may replace
it is an open question of the port (PERF.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rag_arc_tpu_torch.ops.scoring import NEG_INF, l2_normalize, pairwise_scores


def stable_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, score-descending, ties toward the lower
    index. Returns (values, int64 indices)."""
    values, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], order[..., :k]


def masked_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    metric: str = "cosine",
    corpus_sqnorm: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by score with invalid rows excluded: (scores (B, k),
    positions (B, k)). Masked slots score -inf; callers with fewer than k
    valid rows filter them on the host."""
    scores = pairwise_scores(queries, corpus, metric, corpus_sqnorm)
    scores = torch.where(valid[None, :], scores, NEG_INF)
    return stable_topk(scores, k)


def masked_topk_chunked(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid: torch.Tensor,
    sqnorm: torch.Tensor,
    k: int,
    metric: str = "cosine",
    chunk: int = 262144,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Memory-bounded exact top-k: only (B, chunk) scores exist at once,
    merged into a running (B, k). Earlier chunks win ties, as in the JAX
    scan."""
    n = corpus.shape[0]
    if n % chunk != 0:
        raise ValueError(f"corpus rows {n} not a multiple of chunk {chunk}")
    b = queries.shape[0]
    if metric == "cosine":
        queries = l2_normalize(queries)
    run_s = torch.full((b, k), NEG_INF, dtype=torch.float32, device=corpus.device)
    run_p = torch.full((b, k), -1, dtype=torch.int64, device=corpus.device)
    for start in range(0, n, chunk):
        scores = pairwise_scores(
            queries,
            corpus[start : start + chunk],
            "ip" if metric == "cosine" else metric,
            sqnorm[start : start + chunk],
        )
        scores = torch.where(valid[None, start : start + chunk], scores, NEG_INF)
        s, local = stable_topk(scores, k)
        cat_s = torch.cat([run_s, s], dim=1)
        cat_p = torch.cat([run_p, local + start], dim=1)
        run_s, sel = stable_topk(cat_s, k)
        run_p = torch.gather(cat_p, 1, sel)
    return run_s, run_p
