"""BM25 retriever (counterpart of ``rag_arc_tpu/retrieval/bm25.py``).

Surface parity with the reference's ``BM25Retriever``
(``core/retrieval/bm25.py:30``): pluggable ``preprocess_func`` tokenizer
(default whitespace split with a CJK warning, ``bm25.py:116-123``),
``from_texts``/``from_documents`` constructors, ``get_scores`` /
``get_top_k_with_scores``, add/delete with full-rebuild semantics and the
>1000-doc rebuild warning (``bm25.py:390-399``), ``get_bm25_info``, and
disk persistence in the JAX package's ``"rag_arc_tpu.bm25.v1"`` JSON, so
a snapshot loads in either package. Scoring runs through
``DeviceBM25Index`` on the ``device`` every constructor takes.
"""

from __future__ import annotations

import json
import logging
import re
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rag_arc_tpu_torch.index.bm25 import DeviceBM25Index
from rag_arc_tpu_torch.retrieval.base import BaseRetriever
from rag_arc_tpu_torch.utils.data_model import Document

logger = logging.getLogger(__name__)

_CJK_RE = re.compile(r"[一-鿿぀-ヿ가-힯]")

REBUILD_WARN_THRESHOLD = 1000


def default_preprocess(text: str) -> List[str]:
    """Lowercased whitespace tokenization (the reference's default)."""
    return text.lower().split()


_CJK_RUN_RE = re.compile(r"([一-鿿぀-ヿ가-힯]+)")


def cjk_preprocess(text: str) -> List[str]:
    """CJK-aware fallback tokenizer: character bigrams for CJK runs
    (the Lucene CJKAnalyzer scheme — no dictionary needed, so it works
    without jieba), lowercased whitespace words for everything else.

    The reference ships a *working* Chinese BM25 demo via jieba
    pre-tokenization (``examples/test/tantivy_example.py:17-78``); this
    in-tree tokenizer makes CJK corpora retrievable out of the box, and
    a real segmenter passed as ``preprocess_func`` still wins when
    available."""
    tokens: List[str] = []
    for i, piece in enumerate(_CJK_RUN_RE.split(text)):
        if not piece:
            continue
        if i % 2 == 1:  # odd split() indices are the CJK run captures
            if len(piece) == 1:
                tokens.append(piece)
            else:
                tokens.extend(piece[j : j + 2] for j in range(len(piece) - 1))
        else:
            tokens.extend(piece.lower().split())
    return tokens


class BM25Retriever(BaseRetriever):
    def __init__(
        self,
        documents: Optional[Sequence[Document]] = None,
        k: int = 4,
        k1: float = 1.5,
        b: float = 0.75,
        epsilon: float = 0.25,
        preprocess_func: Callable[[str], List[str]] = default_preprocess,
        mesh=None,
        name: Optional[str] = None,
        backend: str = "auto",
        *,
        device: torch.device | str,
    ):
        super().__init__(name=name)
        self.k = k
        self.preprocess_func = preprocess_func
        self.index = DeviceBM25Index(
            k1=k1, b=b, epsilon=epsilon, mesh=mesh, backend=backend, device=device
        )
        self.docs: List[Document] = []
        self._cjk_warned = False
        if documents:
            self.docs = [self._ensure_id(d) for d in documents]
            self._rebuild()

    # -- constructors (bm25.py from_texts/from_documents parity) ----------

    @classmethod
    def from_texts(
        cls,
        texts: Sequence[str],
        metadatas: Optional[Sequence[dict]] = None,
        ids: Optional[Sequence[str]] = None,
        *,
        device: torch.device | str,
        **kwargs: Any,
    ) -> "BM25Retriever":
        metadatas = metadatas or [{} for _ in texts]
        if len(metadatas) != len(texts):
            # zip truncation would silently drop (or mis-pair) documents
            raise ValueError(
                f"texts ({len(texts)}) and metadatas ({len(metadatas)}) "
                "length mismatch"
            )
        if ids is not None and len(ids) != len(texts):
            raise ValueError(
                f"texts ({len(texts)}) and ids ({len(ids)}) length mismatch"
            )
        docs = [
            Document(content=t, metadata=dict(m)) for t, m in zip(texts, metadatas)
        ]
        if ids is not None:
            for d, i in zip(docs, ids):
                d.id = i
        return cls(documents=docs, device=device, **kwargs)

    @classmethod
    def from_documents(
        cls, documents: Sequence[Document], *, device: torch.device | str, **kwargs: Any
    ) -> "BM25Retriever":
        return cls(documents=documents, device=device, **kwargs)

    # -- internals --------------------------------------------------------

    @staticmethod
    def _ensure_id(doc: Document) -> Document:
        doc.ensure_id()
        return doc

    def _tokenize(self, text: str) -> List[str]:
        # queries tokenize with the ACTIVE function — a CJK query must
        # never flip the tokenizer (the corpus tokenization wouldn't
        # change, and the inline full rebuild would block that request
        # for minutes at scale); the corpus decides, in _rebuild
        if (
            self.preprocess_func is default_preprocess
            and not self._cjk_warned
            and _CJK_RE.search(text)
        ):
            self._cjk_warned = True
            warnings.warn(
                "CJK query against a whitespace-tokenized (non-CJK) "
                "corpus — it can only match whole whitespace tokens. "
                "Rebuild with CJK documents (auto-upgrades to the bigram "
                "tokenizer) or pass a segmenter as preprocess_func"
            )
        return self.preprocess_func(text)

    def _maybe_upgrade_cjk(self) -> None:
        """Corpus-driven auto-upgrade: the default whitespace tokenizer
        produces whole-sentence tokens on CJK — switch to the in-tree
        bigram tokenizer so the corpus is actually retrievable (ref
        behavior hint: bm25.py:116-123 points at jieba; we ship a
        dictionary-free remedy)."""
        if self.preprocess_func is default_preprocess and any(
            _CJK_RE.search(d.content) for d in self.docs
        ):
            if not self._cjk_warned:
                self._cjk_warned = True
                warnings.warn(
                    "CJK text detected with the default whitespace "
                    "tokenizer; switching to the in-tree character-bigram "
                    "tokenizer (cjk_preprocess). Pass a real segmenter "
                    "(e.g. jieba.lcut) as preprocess_func for even better "
                    "relevance"
                )
            self.preprocess_func = cjk_preprocess

    def _rebuild(self) -> None:
        # the upgrade decision rides the CORPUS text, never query text
        self._maybe_upgrade_cjk()
        # native fast path: C++ tokenization+stats is byte-exact with the
        # default lower().split() on ASCII corpora
        if self.preprocess_func is default_preprocess and all(
            d.content.isascii() for d in self.docs
        ):
            try:
                self.index.build_from_texts_native([d.content for d in self.docs])
                return
            except Exception as exc:  # noqa: BLE001 — fall back to python build
                logger.warning("native BM25 build unavailable (%s)", exc)
        tokenized = [self._tokenize(d.content) for d in self.docs]
        self.index.build(tokenized)

    # -- retrieval --------------------------------------------------------

    def _get_relevant_documents(self, query: str, **kwargs: Any) -> List[Document]:
        k = int(kwargs.get("k", self.k))
        return [d for d, _ in self.get_top_k_with_scores(query, k)]

    def _get_relevant_documents_batch(
        self, queries: Sequence[str], **kwargs: Any
    ) -> List[List[Document]]:
        k = int(kwargs.get("k", self.k))
        tokenized = [self._tokenize(q) for q in queries]
        scores, positions = self.index.search(tokenized, k)
        out: List[List[Document]] = []
        for srow, prow in zip(scores, positions):
            hits = [self.docs[int(p)] for s, p in zip(srow, prow) if p >= 0]
            out.append(hits)
        return out

    def dispatch_batch(
        self, queries: Sequence[str], **kwargs: Any
    ) -> Callable[[], List[List[Document]]]:
        """Async batched retrieval: tokenize + enqueue now (the index's
        per-query router sends selective queries to the host CSR scorer
        and head-heavy ones to the device coalescer), resolve Documents
        at fetch."""
        k = int(kwargs.get("k", self.k))
        tokenized = [self._tokenize(q) for q in queries]
        pending = self.index.search_dispatch(tokenized, k)

        def fetch() -> List[List[Document]]:
            scores, positions = pending.result()
            return [
                [self.docs[int(p)] for s, p in zip(srow, prow) if p >= 0]
                for srow, prow in zip(scores, positions)
            ]

        # lazy-launch hook: streaming drivers force the coalesced device
        # kernel launch (into their TransferPool) before the first fetch
        fetch.prime = pending.prime  # type: ignore[attr-defined]
        return fetch

    # -- shared-id-space surface (position-space fusion fast path) --------

    def dispatch_positions(
        self, queries: Sequence[str], k: int
    ) -> Callable[[], Tuple[np.ndarray, np.ndarray]]:
        """Async raw-positions search: fetch → (scores, positions) where
        positions index ``self.docs`` (= corpus insertion order)."""
        tokenized = [self._tokenize(q) for q in queries]
        pending = self.index.search_dispatch(tokenized, k)

        def fetch() -> Tuple[np.ndarray, np.ndarray]:
            return pending.result()

        fetch.prime = pending.prime  # type: ignore[attr-defined]
        return fetch

    def resolve_positions(self, rows: Any) -> List[List[Optional[Document]]]:
        n = len(self.docs)
        return [
            [self.docs[int(p)] if 0 <= p < n else None for p in row]
            for row in rows
        ]

    @property
    def position_space_size(self) -> int:
        return len(self.docs)

    def get_top_k_with_scores(
        self, query: str, k: Optional[int] = None
    ) -> List[Tuple[Document, float]]:
        # `k or self.k` would silently swap an explicit k=0 for the default
        k = self.k if k is None else int(k)
        if k < 0:
            raise ValueError(f"k must be >= 0, got {k}")
        if k == 0:  # honored, not crashed (index.search rejects k<=0)
            return []
        scores, positions = self.index.search([self._tokenize(query)], k)
        return [
            (self.docs[int(p)], float(s))
            for s, p in zip(scores[0], positions[0])
            if p >= 0
        ]

    def get_scores(self, query: str):
        """Dense score vector over all documents (bm25.py get_scores parity)."""
        return self.index.get_scores(self._tokenize(query))

    # -- mutation (rebuild semantics, bm25.py:390-399) ---------------------

    def add_documents(self, documents: Sequence[Document]) -> List[str]:
        docs = [self._ensure_id(d) for d in documents]
        self.docs.extend(docs)
        if len(self.docs) > REBUILD_WARN_THRESHOLD:
            warnings.warn(
                f"BM25 rebuild over {len(self.docs)} documents; BM25 global "
                "statistics require a full rebuild on mutation — batch your "
                "adds, or use the dense index for high-churn corpora"
            )
        self._rebuild()
        return [d.id for d in docs]

    def add_texts(
        self, texts: Sequence[str], metadatas: Optional[Sequence[dict]] = None
    ) -> List[str]:
        metadatas = metadatas or [{} for _ in texts]
        if len(metadatas) != len(texts):
            raise ValueError(
                f"texts ({len(texts)}) and metadatas ({len(metadatas)}) "
                "length mismatch"
            )
        return self.add_documents(
            [Document(content=t, metadata=dict(m)) for t, m in zip(texts, metadatas)]
        )

    def delete(self, ids: Sequence[str]) -> bool:
        wanted = set(ids)
        before = len(self.docs)
        self.docs = [d for d in self.docs if d.id not in wanted]
        if len(self.docs) == before:
            return False
        self._rebuild()
        return True

    # -- persistence ------------------------------------------------------

    def save_to_disk(self, path: str | Path) -> None:
        """Persist corpus + parameters as JSON; device arrays are
        deterministically rebuilt at load (unlike the reference's dill
        pickle of live objects, bm25.py:550-609, this format is portable
        and versionable)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "format": "rag_arc_tpu.bm25.v1",
            "params": {
                "k": self.k,
                "k1": self.index.k1,
                "b": self.index.b,
                "epsilon": self.index.epsilon,
                "backend": self.index.backend,
                # the function can't serialize, but its NAME can: in-tree
                # tokenizers restore by name, custom ones warn at load
                "preprocess": getattr(
                    self.preprocess_func, "__name__",
                    repr(self.preprocess_func),
                ),
            },
            "documents": [
                {"content": d.content, "metadata": d.metadata, "id": d.id}
                for d in self.docs
            ],
        }
        path.write_text(json.dumps(payload, ensure_ascii=False), encoding="utf-8")

    @classmethod
    def load_from_disk(
        cls,
        path: str | Path,
        preprocess_func: Callable[[str], List[str]] = default_preprocess,
        mesh=None,
        *,
        device: torch.device | str,
    ) -> "BM25Retriever":
        payload = json.loads(Path(path).read_text(encoding="utf-8"))
        if payload.get("format") != "rag_arc_tpu.bm25.v1":
            raise ValueError(f"unrecognized BM25 snapshot format in {path}")
        params = payload["params"]
        backend = params.get("backend", "auto")
        if mesh is not None and backend == "hybrid":
            # hybrid is single-chip; loading its snapshot onto a mesh
            # downgrades to auto (scores are backend-equivalent)
            logger.warning(
                "BM25 snapshot was saved with the single-chip hybrid "
                "backend; loading onto a mesh with backend='auto'"
            )
            backend = "auto"
        saved_tok = params.get("preprocess")
        have_tok = getattr(preprocess_func, "__name__", repr(preprocess_func))
        if saved_tok and saved_tok != have_tok:
            if saved_tok == "cjk_preprocess" and preprocess_func is default_preprocess:
                # in-tree tokenizer: restore it rather than silently
                # re-tokenizing a CJK corpus with whitespace splits
                preprocess_func = cjk_preprocess
            else:
                logger.warning(
                    "BM25 snapshot was built with tokenizer %r but loading "
                    "with %r — re-pass the original preprocess_func or "
                    "relevance will silently change",
                    saved_tok, have_tok,
                )
        docs = [Document(**d) for d in payload["documents"]]
        return cls(
            documents=docs,
            k=params["k"],
            k1=params["k1"],
            b=params["b"],
            epsilon=params["epsilon"],
            # older v1 snapshots predate the backend field -> auto
            backend=backend,
            preprocess_func=preprocess_func,
            mesh=mesh,
            device=device,
        )

    # -- introspection -----------------------------------------------------

    def get_bm25_info(self) -> Dict[str, Any]:
        info = self.index.stats()
        info["num_documents"] = len(self.docs)
        info["preprocess_func"] = getattr(
            self.preprocess_func, "__name__", repr(self.preprocess_func)
        )
        return info
