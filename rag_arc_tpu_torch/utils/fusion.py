"""Rank fusion for multi-path retrieval.

The port's own copy of ``rag_arc_tpu/utils/fusion.py``, its behaviour
unchanged, so the port imports nothing of the JAX package.

Behavior parity with the reference's ``core/utils/Fusion.py:45-76``
(``RRFusion``: reciprocal-rank-fusion score ``1/(k+rank)`` with ``k=60``,
dedup by document content, sort descending, truncate to ``top_k``), plus a
weighted-score variant. These host-side classes are the API surface; the
batched on-device fusion used inside the multi-path query kernel lives in
``rag_arc_tpu_torch.ops.fusion_kernel`` and is oracle-tested against this code.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Sequence, Tuple

import numpy as np

from rag_arc_tpu_torch.utils.data_model import Document, RetrievalResult


class FusionMethod(ABC):
    """Combine per-path ranked result lists into one ranked list."""

    @abstractmethod
    def fuse(
        self, results: Sequence[Sequence[RetrievalResult]], top_k: int
    ) -> List[Document]:
        """``results`` is one ranked list per retrieval path."""

    def name(self) -> str:
        return type(self).__name__


class RRFusion(FusionMethod):
    """Reciprocal-rank fusion.

    score(doc) = Σ_paths 1 / (k + rank_in_path); docs are deduplicated by
    content string (reference Fusion.py:59-61) so the same chunk surfaced
    by dense and sparse paths accumulates both contributions.
    """

    def __init__(self, k: int = 60):
        if k <= 0:
            raise ValueError(f"RRF k must be positive, got {k}")
        self.k = k

    def fuse(
        self, results: Sequence[Sequence[RetrievalResult]], top_k: int
    ) -> List[Document]:
        scores: Dict[str, float] = {}
        first_seen: Dict[str, Document] = {}
        for path in results:
            for hit in path:
                key = hit.document.content
                scores[key] = scores.get(key, 0.0) + 1.0 / (self.k + hit.rank)
                if key not in first_seen:
                    first_seen[key] = hit.document
        ranked = sorted(scores.items(), key=lambda kv: kv[1], reverse=True)[:top_k]
        fused: List[Document] = []
        for key, score in ranked:
            doc = first_seen[key]
            doc = Document(content=doc.content, metadata=dict(doc.metadata), id=doc.id)
            doc.metadata["fusion_score"] = score
            fused.append(doc)
        return fused

    def fuse_ranked(
        self, doc_lists: Sequence[Sequence[Document]], top_k: int
    ) -> List[Document]:
        """``fuse`` over raw ranked Document lists (one per path), skipping
        the per-hit ``RetrievalResult`` wrapping — the multipath hot path
        allocates 2·B·k of those per batch just to read back ``rank``,
        which is the enumerate index. Identical math and tie behavior:
        rank is 1-based, dedup keys on content, first path listing a
        content keeps its Document."""
        scores: Dict[str, float] = {}
        first_seen: Dict[str, Document] = {}
        for docs in doc_lists:
            for rank, doc in enumerate(docs, start=1):
                key = doc.content
                scores[key] = scores.get(key, 0.0) + 1.0 / (self.k + rank)
                if key not in first_seen:
                    first_seen[key] = doc
        ranked = sorted(scores.items(), key=lambda kv: kv[1], reverse=True)[:top_k]
        fused: List[Document] = []
        for key, score in ranked:
            doc = first_seen[key]
            doc = Document(content=doc.content, metadata=dict(doc.metadata), id=doc.id)
            doc.metadata["fusion_score"] = score
            fused.append(doc)
        return fused


class WeightedScoreFusion(FusionMethod):
    """Min-max-normalize each path's scores to [0,1], then weighted sum.

    Not present in the reference (which ships only RRF) but a standard
    companion; weights default to uniform.
    """

    def __init__(self, weights: Sequence[float] | None = None):
        self.weights = list(weights) if weights is not None else None

    def fuse(
        self, results: Sequence[Sequence[RetrievalResult]], top_k: int
    ) -> List[Document]:
        n_paths = len(results)
        weights = self.weights or [1.0] * n_paths
        if len(weights) != n_paths:
            raise ValueError(
                f"got {len(weights)} weights for {n_paths} retrieval paths"
            )
        scores: Dict[str, float] = {}
        first_seen: Dict[str, Document] = {}
        for w, path in zip(weights, results):
            if not path:
                continue
            raw = [hit.score for hit in path]
            lo, hi = min(raw), max(raw)
            uniform = hi == lo
            span = (hi - lo) or 1.0
            for hit in path:
                key = hit.document.content
                # a single-hit or uniform-score path contributes its FULL
                # weight, not zero — min-max collapse silently discarded
                # exactly the paths most confident in their one answer
                norm = 1.0 if uniform else (hit.score - lo) / span
                scores[key] = scores.get(key, 0.0) + w * norm
                first_seen.setdefault(key, hit.document)
        ranked = sorted(scores.items(), key=lambda kv: kv[1], reverse=True)[:top_k]
        fused = []
        for key, score in ranked:
            doc = first_seen[key]
            doc = Document(content=doc.content, metadata=dict(doc.metadata), id=doc.id)
            doc.metadata["fusion_score"] = score
            fused.append(doc)
        return fused


def rrf_fuse_positions_np(
    paths_pos: Sequence[np.ndarray], top_k: int, rrf_k: int = 60
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched RRF over integer position arrays — the shared-id-space hot
    path (``MultiPathRetriever(shared_id_space=True)``).

    ``paths_pos`` is one ``(B, k_path)`` int array per path (ranked, -1 =
    empty slot). Returns ``(scores (B, top_k), positions (B, top_k))``
    with -inf / -1 padding. Identical math AND tie order to
    :meth:`RRFusion.fuse` when every path's positions map to distinct
    documents: score = Σ 1/(rrf_k + rank), rank 1-based per path; ties
    break by FIRST OCCURRENCE across the concatenated path order —
    exactly the insertion order of ``RRFusion``'s score dict (Python's
    stable sort keeps dict order for equal scores).

    Fully vectorized (one stable argsort groups duplicate ids per row;
    a cumsum-difference computes per-group totals) — no per-candidate
    Python objects, which is what makes the composed pipeline's fuse
    stage ~free instead of ~11 ms per 128-query batch.
    """
    if not paths_pos:
        raise ValueError("need at least one path")
    b = paths_pos[0].shape[0]
    flat = np.concatenate(
        [np.asarray(p, dtype=np.int64) for p in paths_pos], axis=1
    )  # (B, M) in path-major, rank-minor order = first-seen order
    m = flat.shape[1]
    contrib = np.concatenate(
        [
            1.0 / (rrf_k + np.arange(1, p.shape[1] + 1, dtype=np.float64))
            for p in paths_pos
        ]
    )  # (M,)
    contrib = np.broadcast_to(contrib, (b, m)).copy()
    contrib[flat < 0] = 0.0

    # group duplicate ids per row: stable argsort keeps original (=first
    # occurrence) order within each id group
    order = np.argsort(flat, axis=1, kind="stable")
    sorted_ids = np.take_along_axis(flat, order, axis=1)
    sorted_contrib = np.take_along_axis(contrib, order, axis=1)
    is_first = np.ones((b, m), dtype=bool)
    is_first[:, 1:] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
    # per-group totals, summed LEFT-TO-RIGHT in original (= path) order —
    # bit-identical to RRFusion's dict accumulation, so exact ties stay
    # exact (a cumsum-difference here broke tie order by ~1 ulp). A group
    # has at most len(paths) members (an id appears once per ranked
    # path), so this is a P-step vectorized loop, not O(m).
    group_total = sorted_contrib.copy()
    cols = np.arange(m)[None, :]
    for s in range(1, len(paths_pos)):
        j = np.clip(cols + s, 0, m - 1)
        same = (cols + s < m) & (
            np.take_along_axis(sorted_ids, j, axis=1) == sorted_ids
        )
        group_total += np.where(
            same, np.take_along_axis(sorted_contrib, j, axis=1), 0.0
        )

    # scatter each group's total to its FIRST occurrence's original slot;
    # non-first / invalid entries write to a dummy column m instead of
    # risking a clobber (fancy assignment is last-write-wins)
    out_scores = np.full((b, m + 1), -np.inf)
    rows = np.arange(b)[:, None]
    valid_first = is_first & (sorted_ids >= 0)
    out_scores[rows, np.where(valid_first, order, m)] = group_total
    out_scores = out_scores[:, :m]

    sel = np.argsort(-out_scores, axis=1, kind="stable")[:, :top_k]
    fused_scores = np.take_along_axis(out_scores, sel, axis=1)
    fused_pos = np.take_along_axis(flat, sel, axis=1)
    fused_pos[np.isneginf(fused_scores)] = -1
    return fused_scores, fused_pos


def results_from_ranked_docs(
    docs: Sequence[Document], source: str
) -> List[RetrievalResult]:
    """Wrap a retriever's RANKED documents as RetrievalResults.

    Leaf retrievers return ordered documents without scores; the score
    here is the reciprocal-rank proxy ``1/rank`` — monotone with the
    path's own ranking, so ``WeightedScoreFusion`` gets a real signal
    (a fabricated 0.0 collapsed it to unweighted insertion order).
    ``RRFusion`` reads only ``rank`` and is unaffected.
    """
    return [
        RetrievalResult(document=doc, score=1.0 / rank, rank=rank, source=source)
        for rank, doc in enumerate(docs, start=1)
    ]
