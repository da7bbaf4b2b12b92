"""Embeddings API.

The port's own copy of ``rag_arc_tpu/models/embeddings.py``, its behaviour unchanged, so
the port imports nothing of the JAX package.

Parity with the reference's ``core/file_management/embeddings/base.py:7-61``
(``embed_documents`` / ``embed_query`` + async variants). Implementations:

- ``HashEmbeddings`` — deterministic, dependency-free fake for tests and
  CPU-runnable pipelines (SURVEY.md §4 demands a deterministic fake
  embedder so the whole engine is testable without model weights).
- ``TorchEncoderEmbeddings`` (``rag_arc_tpu_torch.models.torch_embeddings``)
  — the device path: the transformer encoder run as a batched forward
  pass.

Async variants run the sync implementation in a thread executor, matching
the reference's shim semantics (``embeddings/base.py``), since the real
work is a device dispatch that releases the GIL.
"""

from __future__ import annotations

import asyncio
import hashlib
import re
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np


class Embeddings(ABC):
    """Text → fixed-dim vector interface."""

    _executor: Optional[ThreadPoolExecutor] = None

    @abstractmethod
    def embed_documents(self, texts: List[str]) -> List[List[float]]:
        """Embed a batch of document texts."""

    def embed_query(self, text: str) -> List[float]:
        """Embed a single query (default: the document path on one text)."""
        return self.embed_documents([text])[0]

    # numpy fast path used by the index layer (avoids list-of-list churn)
    def encode(self, texts: List[str]) -> np.ndarray:
        return np.asarray(self.embed_documents(texts), dtype=np.float32)

    def describe(self) -> dict:
        """Snapshot-manifest spec: enough to rebuild an EQUIVALENT query
        embedder at load time, or to refuse when that is impossible.
        ``reproducible=False`` means a fresh instance will NOT produce the
        same vectors (e.g. externally-loaded weights) — serving must then
        be configured explicitly instead of guessing."""
        return {
            "kind": type(self).__name__,
            "dim": getattr(self, "dim", None),
            "reproducible": False,
        }

    async def aembed_documents(self, texts: List[str]) -> List[List[float]]:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._get_executor(), self.embed_documents, texts
        )

    async def aembed_query(self, text: str) -> List[float]:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._get_executor(), self.embed_query, text)

    @classmethod
    def _get_executor(cls) -> ThreadPoolExecutor:
        if Embeddings._executor is None:
            Embeddings._executor = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="embed"
            )
        return Embeddings._executor


class HashEmbeddings(Embeddings):
    """Deterministic bag-of-token-hash embeddings.

    Each token maps to a fixed pseudo-random unit vector seeded by its
    md5; a text embeds to the L2-normalized sum of its token vectors.
    Texts sharing tokens are therefore similar — enough structure for
    recall tests, chunker tests, and end-to-end pipeline tests with zero
    model weights.
    """

    _TOKEN_RE = re.compile(r"\w+", re.UNICODE)

    def __init__(self, dim: int = 64):
        if dim <= 0:
            raise ValueError("dim must be positive")
        self.dim = dim
        self._cache: Dict[str, np.ndarray] = {}

    def describe(self) -> dict:
        # content-hash seeded: any instance at the same dim is identical
        return {"kind": "hash", "dim": self.dim, "reproducible": True}

    def _token_vector(self, token: str) -> np.ndarray:
        vec = self._cache.get(token)
        if vec is None:
            seed = int.from_bytes(
                hashlib.md5(token.encode("utf-8")).digest()[:8], "little"
            )
            vec = np.random.default_rng(seed).standard_normal(self.dim)
            vec = (vec / np.linalg.norm(vec)).astype(np.float32)
            self._cache[token] = vec
        return vec

    def _embed_one(self, text: str) -> np.ndarray:
        tokens = self._TOKEN_RE.findall(text.lower())
        if not tokens:
            return np.zeros(self.dim, dtype=np.float32)
        acc = np.sum([self._token_vector(t) for t in tokens], axis=0)
        norm = np.linalg.norm(acc)
        return (acc / norm).astype(np.float32) if norm > 0 else acc.astype(np.float32)

    def embed_documents(self, texts: List[str]) -> List[List[float]]:
        return [self._embed_one(t).tolist() for t in texts]

    def encode(self, texts: List[str]) -> np.ndarray:
        return np.stack([self._embed_one(t) for t in texts]) if texts else np.empty(
            (0, self.dim), dtype=np.float32
        )
