"""Similarity scoring primitives (counterpart of ``rag_arc_tpu/ops/scoring.py``).

Every metric is one batched product, larger meaning more similar:

  cosine  : q̂ @ Êᵀ                      (both sides pre-normalized)
  ip      : q @ Eᵀ
  l2      : -(‖q‖² - 2 q·e + ‖e‖²)

Scores are f32 whatever the storage type. A bf16 corpus is scored with
its values widened to f32 (bf16 products are exact in f32), so rankings
match the JAX package's f32-accumulated dot; the widening runs in row
chunks so a large corpus never exists twice in f32.
"""

from __future__ import annotations

from typing import Optional

import torch

METRICS = ("cosine", "ip", "l2")

NEG_INF = float("-inf")

# rows widened to f32 at a time when scoring a low-precision corpus
_WIDEN_ROWS = 1 << 16


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-normalize to unit L2 norm (safe at zero)."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def dot_f32(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """(B, d) × (N, d) → (B, N) f32 products; a non-f32 corpus is widened
    in row chunks, so it never exists twice in f32."""
    q32 = queries.float()
    if corpus.dtype == torch.float32:
        return q32 @ corpus.T
    return torch.cat(
        [q32 @ part.float().T for part in corpus.split(_WIDEN_ROWS)], dim=1
    )


def pairwise_scores(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    metric: str,
    corpus_sqnorm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, d) × (N, d) → (B, N) f32 scores where larger means more similar.

    For ``cosine`` the corpus is assumed pre-normalized (done at add time
    by the index); queries are normalized here. Queries are rounded to the
    corpus dtype first, as the JAX package does."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}, expected one of {METRICS}")
    queries = queries.to(corpus.dtype)
    if metric == "cosine":
        queries = l2_normalize(queries)
    cross = dot_f32(queries, corpus)
    if metric in ("cosine", "ip"):
        return cross
    if corpus_sqnorm is None:
        corpus_sqnorm = torch.cat(
            [(p.float() * p.float()).sum(dim=-1) for p in corpus.split(_WIDEN_ROWS)]
        )
    q32 = queries.float()
    q_sqnorm = torch.sum(q32 * q32, dim=-1, keepdim=True)
    return -(q_sqnorm - 2.0 * cross + corpus_sqnorm[None, :])
