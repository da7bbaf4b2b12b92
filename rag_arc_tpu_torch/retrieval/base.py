"""Retriever base class.

A copy of ``rag_arc_tpu/retrieval/base.py``: the port imports nothing
of the JAX package.

Parity with the reference's ``core/retrieval/base.py:8-100``:
``invoke``/``ainvoke`` public entries, subclasses implement
``_get_relevant_documents``, default async runs the sync path in a thread
executor. Extended with a first-class **batched** entry (``invoke_batch``)
— on an accelerator the natural unit of work is a query batch, and subclasses
override ``_get_relevant_documents_batch`` to answer N queries in one
device dispatch.
"""

from __future__ import annotations

import asyncio
import logging
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Sequence

from rag_arc_tpu_torch.utils.data_model import Document

logger = logging.getLogger(__name__)


class BaseRetriever(ABC):
    """Query → ranked documents."""

    _executor: Optional[ThreadPoolExecutor] = None

    def __init__(self, name: Optional[str] = None):
        self.name = name or type(self).__name__

    @abstractmethod
    def _get_relevant_documents(self, query: str, **kwargs: Any) -> List[Document]: ...

    def _get_relevant_documents_batch(
        self, queries: Sequence[str], **kwargs: Any
    ) -> List[List[Document]]:
        """Default batched path: loop. Device-backed subclasses override
        this with a single batched dispatch."""
        return [self._get_relevant_documents(q, **kwargs) for q in queries]

    # -- public entries ---------------------------------------------------

    def invoke(self, query: str, **kwargs: Any) -> List[Document]:
        if not isinstance(query, str) or not query.strip():
            raise ValueError("query must be a non-empty string")
        return self._get_relevant_documents(query, **kwargs)

    def invoke_batch(self, queries: Sequence[str], **kwargs: Any) -> List[List[Document]]:
        for q in queries:
            if not isinstance(q, str) or not q.strip():
                raise ValueError("queries must be non-empty strings")
        if not queries:
            return []
        return self._get_relevant_documents_batch(list(queries), **kwargs)

    async def ainvoke(self, query: str, **kwargs: Any) -> List[Document]:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._get_pool(), lambda: self.invoke(query, **kwargs)
        )

    async def ainvoke_batch(
        self, queries: Sequence[str], **kwargs: Any
    ) -> List[List[Document]]:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._get_pool(), lambda: self.invoke_batch(queries, **kwargs)
        )

    @classmethod
    def _get_pool(cls) -> ThreadPoolExecutor:
        if BaseRetriever._executor is None:
            BaseRetriever._executor = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="retriever"
            )
        return BaseRetriever._executor
