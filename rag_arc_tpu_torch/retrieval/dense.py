"""Dense retriever over a vector store (counterpart of
``rag_arc_tpu/retrieval/dense.py``, the same code over the port's store).

Three search types (``similarity``, ``similarity_score_threshold`` with
the threshold validated in [0, 1], and ``mmr``), ``search_kwargs``
merging with per-call overrides, truncation to k, add/delete/get_by_ids
pass-through, and ``get_vectorstore_info``. The batched path answers many
queries in one device dispatch via
``TorchVectorStore.batch_similarity_search_with_score``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

from rag_arc_tpu.utils.data_model import Document
from rag_arc_tpu_torch.index.vector_store import VectorStore
from rag_arc_tpu_torch.retrieval.base import BaseRetriever

SEARCH_TYPES = ("similarity", "similarity_score_threshold", "mmr")


class VectorStoreRetriever(BaseRetriever):
    def __init__(
        self,
        vectorstore: VectorStore,
        search_type: str = "similarity",
        search_kwargs: Optional[Dict[str, Any]] = None,
        name: Optional[str] = None,
    ):
        super().__init__(name=name)
        if search_type not in SEARCH_TYPES:
            raise ValueError(
                f"search_type must be one of {SEARCH_TYPES}, got {search_type!r}"
            )
        search_kwargs = dict(search_kwargs or {})
        if search_type == "similarity_score_threshold":
            threshold = search_kwargs.get("score_threshold")
            if threshold is None:
                raise ValueError(
                    "similarity_score_threshold search requires a "
                    "`score_threshold` in search_kwargs"
                )
            if not 0.0 <= float(threshold) <= 1.0:
                raise ValueError(
                    f"score_threshold must be in [0, 1], got {threshold}"
                )
        self.vectorstore = vectorstore
        self.search_type = search_type
        self.search_kwargs = search_kwargs

    def _merged_kwargs(self, overrides: Dict[str, Any]) -> Dict[str, Any]:
        merged = dict(self.search_kwargs)
        merged.update(overrides)
        merged.setdefault("k", 4)
        return merged

    def _get_relevant_documents(self, query: str, **kwargs: Any) -> List[Document]:
        merged = self._merged_kwargs(kwargs)
        k = int(merged.pop("k"))
        if self.search_type == "similarity":
            docs = self.vectorstore.similarity_search(query, k=k, **merged)
        elif self.search_type == "similarity_score_threshold":
            scored = self.vectorstore.similarity_search_with_relevance_scores(
                query, k=k, **merged
            )
            docs = [d for d, _ in scored]
        else:  # mmr
            docs = self.vectorstore.max_marginal_relevance_search(query, k=k, **merged)
        return docs[:k]

    def _get_relevant_documents_batch(
        self, queries: Sequence[str], **kwargs: Any
    ) -> List[List[Document]]:
        merged = self._merged_kwargs(kwargs)
        k = int(merged.pop("k"))
        batch_fn = getattr(self.vectorstore, "batch_similarity_search_with_score", None)
        if self.search_type == "similarity" and batch_fn is not None:
            results = batch_fn(queries, k=k)
            return [[d for d, _ in hits][:k] for hits in results]
        # per-query fallback (mmr / score-threshold): kwargs may itself
        # carry 'k' (the serving path always passes it) — strip it or the
        # explicit k=k below raises 'multiple values for keyword argument'
        rest = {kk: vv for kk, vv in kwargs.items() if kk != "k"}
        return [self._get_relevant_documents(q, k=k, **rest) for q in queries]

    def dispatch_batch(
        self, queries: Sequence[str], **kwargs: Any
    ) -> Optional[Callable[[], List[List[Document]]]]:
        """Async batched retrieval: enqueue the device search now, return
        a fetch callable resolving to ranked Documents per query — or
        ``None`` when this configuration has no async path (mmr /
        score-threshold re-rank on host per query). Streaming callers
        (``RagPipeline.query_batches``, ``MultiPathRetriever``) dispatch
        every batch/path first so device programs overlap host work."""
        merged = self._merged_kwargs(kwargs)
        k = int(merged.pop("k"))
        dispatch_fn = getattr(self.vectorstore, "dispatch_batch_search", None)
        if self.search_type != "similarity" or dispatch_fn is None:
            return None
        fetch_scored = dispatch_fn(queries, k=k)

        def fetch() -> List[List[Document]]:
            return [[d for d, _ in hits][:k] for hits in fetch_scored()]

        return fetch

    # -- shared-id-space surface (position-space fusion fast path) --------

    def dispatch_positions(
        self, queries: Sequence[str], k: int
    ) -> Optional[Callable[[], Any]]:
        """Async raw-positions search: fetch → (scores, positions) in the
        store's docstore position space. ``None`` when unavailable."""
        if self.search_type != "similarity":
            return None
        fn = getattr(self.vectorstore, "dispatch_search_raw", None)
        return None if fn is None else fn(queries, k=k)

    def resolve_positions(self, rows: Any) -> List[List[Optional[Document]]]:
        return self.vectorstore.resolve_positions(rows)

    @property
    def position_space_size(self) -> Optional[int]:
        return getattr(self.vectorstore, "position_space_size", None)

    # -- pass-throughs (dense.py add/delete/get_by_ids parity) ------------

    def add_documents(self, documents: Sequence[Document], **kwargs: Any) -> List[str]:
        return self.vectorstore.add_documents(documents, **kwargs)

    def delete(self, ids: Sequence[str]) -> bool:
        return self.vectorstore.delete(ids)

    def get_by_ids(self, ids: Sequence[str]) -> List[Document]:
        return self.vectorstore.get_by_ids(ids)

    def get_vectorstore_info(self) -> Dict[str, Any]:
        return self.vectorstore.get_vectorstore_info()
