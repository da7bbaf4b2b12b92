"""Retrievers: dense (over a vector store), BM25, and multi-path with rank
fusion."""

from rag_arc_tpu_torch.retrieval.base import BaseRetriever
from rag_arc_tpu_torch.retrieval.bm25 import BM25Retriever
from rag_arc_tpu_torch.retrieval.dense import VectorStoreRetriever
from rag_arc_tpu_torch.retrieval.multipath import MultiPathRetriever

__all__ = [
    "BaseRetriever",
    "BM25Retriever",
    "VectorStoreRetriever",
    "MultiPathRetriever",
]
