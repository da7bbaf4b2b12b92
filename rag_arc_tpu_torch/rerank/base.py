"""Reranker interface.

A copy of ``rag_arc_tpu/rerank/base.py``: the port imports nothing of
the JAX package.

Parity with the reference's ``RerankerBase`` (``core/rerank/base.py:5-27``):
``rerank(query, documents, **kw) -> list[Document]`` sorted by relevance,
truncated to ``k``. Implementations attach their score in
``metadata["rerank_score"]``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, List, Sequence

from rag_arc_tpu_torch.utils.data_model import Document


class RerankerBase(ABC):
    @abstractmethod
    def rerank(
        self, query: str, documents: Sequence[Document], **kwargs: Any
    ) -> List[Document]: ...

    def rerank_with_scores(
        self, query: str, documents: Sequence[Document], **kwargs: Any
    ) -> List[tuple[Document, float]]:
        docs = self.rerank(query, documents, **kwargs)
        return [(d, float(d.metadata.get("rerank_score", 0.0))) for d in docs]
