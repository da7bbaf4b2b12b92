"""Multi-round LLM graph extraction base.

The port's own copy of ``rag_arc_tpu/graph/extractor.py``, its behaviour unchanged,
so the port imports nothing of the JAX package.

Parity with the reference's ``GraphExtractorBase``
(``core/file_management/extractor/Base_GraphExtractor.py:15``): per-document
extraction loop up to ``max_rounds`` merging each round into a history
(upsert by id), an ``is_extraction_complete`` early-exit hook, document
fan-out under ``asyncio.Semaphore(max_concurrent)``, an optional clean
pass, and the full sync/async entry matrix (``__call__``/``acall``/
``extract_only``/``aextract_only``/``clean_only``/``aclean_only``).
"""

from __future__ import annotations

import asyncio
import logging
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import List, Optional, Sequence

from rag_arc_tpu_torch.graph.schema import KnowledgeStructure
from rag_arc_tpu_torch.llm.base import LLMBase
from rag_arc_tpu_torch.utils.data_model import Document

logger = logging.getLogger(__name__)


@dataclass
class ExtractionResult:
    document: Document
    knowledge: KnowledgeStructure
    rounds: int = 0


class GraphExtractorBase(ABC):
    def __init__(
        self,
        llm: LLMBase,
        max_rounds: int = 3,
        max_concurrent: int = 100,
        clean: bool = True,
    ):
        self.llm = llm
        self.max_rounds = max_rounds
        self.max_concurrent = max_concurrent
        self.clean = clean

    # -- subclass hooks -----------------------------------------------------

    @abstractmethod
    async def _extract_round(
        self, document: Document, history: KnowledgeStructure, round_idx: int
    ) -> KnowledgeStructure:
        """One LLM extraction round; returns this round's (possibly
        overlapping) output."""

    @abstractmethod
    def _merge(
        self, history: KnowledgeStructure, new: KnowledgeStructure
    ) -> tuple[KnowledgeStructure, int]:
        """Upsert ``new`` into ``history``; returns (merged, n_new_items)."""

    def is_extraction_complete(
        self, history: KnowledgeStructure, round_idx: int, n_new: int
    ) -> bool:
        """Early-exit hook (default: stop when a round adds nothing)."""
        return n_new == 0

    async def _clean(self, result: ExtractionResult) -> ExtractionResult:
        """Optional post-pass; default is identity."""
        return result

    # -- per-document loop --------------------------------------------------

    async def _aprocess_document(self, document: Document) -> ExtractionResult:
        history = KnowledgeStructure()
        rounds_run = 0
        for round_idx in range(self.max_rounds):
            try:
                new = await self._extract_round(document, history, round_idx)
            except Exception as exc:  # noqa: BLE001 — per-doc isolation
                logger.warning(
                    "extraction round %d failed for doc %s: %s",
                    round_idx,
                    document.id,
                    exc,
                )
                break
            history, n_new = self._merge(history, new)
            rounds_run = round_idx + 1
            if self.is_extraction_complete(history, round_idx, n_new):
                break
        # plain dict, NOT the pydantic object: documents flow onward into
        # docstores/snapshots that json.dumps their metadata — a live
        # KnowledgeStructure there crashes the standard extract-then-index
        # flow at ingest/save time
        document.metadata["knowledge"] = history.model_dump()
        return ExtractionResult(document=document, knowledge=history, rounds=rounds_run)

    # -- fan-out ------------------------------------------------------------

    async def aextract_only(
        self, documents: Sequence[Document]
    ) -> List[ExtractionResult]:
        sem = asyncio.Semaphore(self.max_concurrent)

        async def bounded(doc: Document) -> ExtractionResult:
            async with sem:
                return await self._aprocess_document(doc)

        total = len(documents)
        results: List[ExtractionResult] = []
        done = 0
        for coro in asyncio.as_completed([bounded(d) for d in documents]):
            results.append(await coro)
            done += 1
            if done % 10 == 0 or done == total:
                logger.info("extraction progress: %d/%d documents", done, total)
        order = {id(d): i for i, d in enumerate(documents)}
        results.sort(key=lambda r: order.get(id(r.document), 0))
        return results

    async def aclean_only(
        self, results: Sequence[ExtractionResult]
    ) -> List[ExtractionResult]:
        # same fan-out discipline as extraction: one awaited LLM round
        # trip per document in sequence would dominate wall-clock ~100x
        sem = asyncio.Semaphore(self.max_concurrent)

        async def bounded(r: ExtractionResult) -> ExtractionResult:
            async with sem:
                return await self._clean(r)

        return list(await asyncio.gather(*(bounded(r) for r in results)))

    async def acall(self, documents: Sequence[Document]) -> List[ExtractionResult]:
        results = await self.aextract_only(documents)
        if self.clean:
            results = await self.aclean_only(results)
        return results

    # -- sync twins -----------------------------------------------------------

    def extract_only(self, documents: Sequence[Document]) -> List[ExtractionResult]:
        return asyncio.run(self.aextract_only(documents))

    def clean_only(self, results: Sequence[ExtractionResult]) -> List[ExtractionResult]:
        return asyncio.run(self.aclean_only(results))

    def __call__(self, documents: Sequence[Document]) -> List[ExtractionResult]:
        return asyncio.run(self.acall(documents))
