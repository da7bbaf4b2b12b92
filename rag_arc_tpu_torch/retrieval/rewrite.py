"""Multi-query rewrite retrieval.

The port's own copy of ``rag_arc_tpu/retrieval/rewrite.py``, its behaviour
unchanged, so the port imports nothing of the JAX package.

The reference reserves ``core/query_rewrite/`` as an empty stub
(SURVEY.md §1 quirks) but names it in the BASELINE configs, so the design
here is free: an LLM generates N query variants (structured output), the
variants PLUS the original are answered **in one batched retrieval
dispatch** (``invoke_batch`` — on TPU this is a single XLA program over the
stacked query batch), and the per-variant rankings are fused with RRF,
deduplicating documents that multiple phrasings surface.
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional

from pydantic import BaseModel, Field

from rag_arc_tpu_torch.llm.base import LLMBase
from rag_arc_tpu_torch.retrieval.base import BaseRetriever
from rag_arc_tpu_torch.utils.data_model import Document, RetrievalResult
from rag_arc_tpu_torch.utils.fusion import FusionMethod, RRFusion, results_from_ranked_docs

logger = logging.getLogger(__name__)

REWRITE_PROMPT = (
    "You rewrite search queries. Generate {n} alternative phrasings of the "
    "user's query that could surface different relevant documents: use "
    "synonyms, different specificity levels, and decomposition of compound "
    "questions. Return only the rewritten queries.\n\nQuery: {query}"
)


class QueryVariants(BaseModel):
    queries: List[str] = Field(description="alternative phrasings of the query")


class MultiQueryRewriter:
    """LLM-backed query expansion."""

    def __init__(
        self,
        llm: LLMBase,
        n_variants: int = 3,
        prompt_template: str = REWRITE_PROMPT,
    ):
        self.llm = llm
        self.n_variants = n_variants
        self.prompt_template = prompt_template

    def rewrite(self, query: str) -> List[str]:
        """Returns up to n_variants distinct non-empty rewrites (never the
        original, never duplicates). LLM failure degrades to no variants."""
        prompt = self.prompt_template.format(n=self.n_variants, query=query)
        try:
            out = self.llm.parse_chat(
                [{"role": "user", "content": prompt}], QueryVariants
            )
        except Exception as exc:  # noqa: BLE001 — rewrite is best-effort
            logger.warning("query rewrite failed (%s); using original only", exc)
            return []
        seen = {query.strip().lower()}
        variants = []
        for q in out.queries:
            q = q.strip()
            if q and q.lower() not in seen:
                seen.add(q.lower())
                variants.append(q)
            if len(variants) >= self.n_variants:
                break
        return variants


class RewriteRetriever(BaseRetriever):
    """Retriever wrapper: rewrite → one batched dispatch → fused ranking."""

    def __init__(
        self,
        retriever: BaseRetriever,
        rewriter: MultiQueryRewriter,
        fusion_method: Optional[FusionMethod] = None,
        top_k: int = 10,
        k_per_query: int = 20,
        include_original: bool = True,
        name: Optional[str] = None,
    ):
        super().__init__(name=name)
        self.retriever = retriever
        self.rewriter = rewriter
        self.fusion_method = fusion_method or RRFusion()
        self.top_k = top_k
        self.k_per_query = k_per_query
        self.include_original = include_original
        self._last_variants: List[str] = []

    def _get_relevant_documents(self, query: str, **kwargs: Any) -> List[Document]:
        top_k = int(kwargs.get("k", self.top_k))
        queries = self.rewriter.rewrite(query)
        self._last_variants = list(queries)
        if self.include_original or not queries:
            queries = [query] + queries
        # fully fused path: when the wrapped retriever is a dense retriever
        # over a device store and fusion is RRF, dispatch all variants in
        # one program and fuse on device (ops.fusion_kernel)
        store = getattr(self.retriever, "vectorstore", None)
        if (
            isinstance(self.fusion_method, RRFusion)
            and store is not None
            and hasattr(store, "multi_query_search")
        ):
            hits = store.multi_query_search(
                [queries],
                k=top_k,
                k_per_variant=self.k_per_query,
                rrf_k=self.fusion_method.k,
            )[0]
            out = []
            for doc, score in hits:
                doc = Document(
                    content=doc.content, metadata=dict(doc.metadata), id=doc.id
                )
                doc.metadata["fusion_score"] = score
                out.append(doc)
            return out
        per_query = self.retriever.invoke_batch(queries, k=self.k_per_query)
        paths = [
            results_from_ranked_docs(docs, source=f"q{qi}")
            for qi, docs in enumerate(per_query)
        ]
        return self.fusion_method.fuse(paths, top_k)

    def last_variants(self, query: Optional[str] = None) -> List[str]:
        """The rewrites the LAST invoke actually retrieved with — not a
        fresh (nondeterministic, costed) LLM call, which could return a
        different set than the one that produced the ranking."""
        return list(self._last_variants)
