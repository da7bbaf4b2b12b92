"""Core data model.

The port's own copy of ``rag_arc_tpu/utils/data_model.py``, its behaviour unchanged, so
the port imports nothing of the JAX package.

Capability parity with the reference's ``core/utils/data_model.py:4-9``
(``Document{content, metadata, id}``) and ``core/utils/Fusion.py:9-21``
(``RetrievalResult{document, score, rank}``), redesigned as lightweight
dataclasses: these objects live on the *host* side of the engine — device
code only ever sees integer positions and float scores, and positions are
resolved back to ``Document`` objects at the very end of a query.
"""

from __future__ import annotations

import hashlib
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class Document:
    """A unit of retrievable content plus free-form metadata."""

    content: str
    metadata: Dict[str, Any] = field(default_factory=dict)
    id: Optional[str] = None

    def ensure_id(self) -> str:
        """Assign a random id if the document has none; return the id."""
        if self.id is None:
            self.id = uuid.uuid4().hex
        return self.id

    def content_hash(self) -> str:
        """Stable content-derived id (used for ingestion idempotence,
        mirroring the reference's md5-prefix ids, Base_Neo4j.py:95-107)."""
        return hashlib.md5(self.content.encode("utf-8")).hexdigest()

    def __repr__(self) -> str:  # keep long contents out of logs
        preview = self.content[:60].replace("\n", " ")
        ellipsis = "…" if len(self.content) > 60 else ""
        return f"Document(id={self.id!r}, content={preview!r}{ellipsis})"


@dataclass
class RetrievalResult:
    """One scored hit from a single retrieval path.

    ``rank`` is the 1-based position within its source path's result list
    (reference ``Fusion.py`` assigns ``rank = i + 1``, so the top hit's RRF
    contribution is ``1/(k+1)``); fusion methods consume ranks, not raw
    scores, so heterogeneous score scales (cosine vs BM25) compose cleanly.
    """

    document: Document
    score: float
    rank: int
    source: Optional[str] = None  # which retriever produced this hit
