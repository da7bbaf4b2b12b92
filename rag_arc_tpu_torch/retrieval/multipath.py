"""Multi-path retrieval with rank fusion (the port's copy of
``rag_arc_tpu/retrieval/multipath.py``, its behaviour unchanged).

Parity with the reference's ``MultiPathRetriever``
(``core/retrieval/mutipath.py:8``): fan a query out to N retrievers
(``top_k_per_retriever`` each, default 50), convert hits to
``RetrievalResult``, fuse with a ``FusionMethod`` (default RRF), return the
fused top-k; a failing path contributes an empty list and the query
continues (``mutipath.py:78-80``). ``add_retriever`` / ``remove_retriever``
/ ``set_fusion_method`` management included.

Batched entry: the fan-out is per *batch*: each path answers all queries
in one device dispatch (``invoke_batch``), so a hybrid dense+BM25
configuration costs two dispatches in all rather than 2·B sequential
searches.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from rag_arc_tpu_torch.retrieval.base import BaseRetriever
from rag_arc_tpu_torch.utils.data_model import Document, RetrievalResult
from rag_arc_tpu_torch.utils.fusion import (
    FusionMethod,
    RRFusion,
    results_from_ranked_docs,
    rrf_fuse_positions_np,
)

logger = logging.getLogger(__name__)


class MultiPathRetriever(BaseRetriever):
    def __init__(
        self,
        retrievers: Sequence[BaseRetriever],
        fusion_method: Optional[FusionMethod] = None,
        top_k: int = 10,
        top_k_per_retriever: int = 50,
        name: Optional[str] = None,
        shared_id_space: bool = False,
    ):
        super().__init__(name=name)
        if not retrievers:
            raise ValueError("MultiPathRetriever needs at least one retriever")
        self.retrievers: List[BaseRetriever] = list(retrievers)
        self.fusion_method = fusion_method or RRFusion()
        self.top_k = top_k
        self.top_k_per_retriever = top_k_per_retriever
        # shared_id_space=True asserts every path indexes the SAME corpus
        # in the SAME order (position i means the same document in all
        # paths, and positions are the document identity — duplicate
        # contents at different positions stay distinct). Fusion then
        # runs on integer positions (utils.fusion.rrf_fuse_positions_np,
        # bit-exact RRFusion parity) and only the fused top-k documents
        # materialize — the content-keyed path materializes every path's
        # every candidate (P·k_path docs/query) just to fuse and discard
        # most of them. Validated lazily (sizes + sampled id agreement);
        # on mismatch the retriever warns once and falls back to
        # content-keyed fusion.
        self.shared_id_space = shared_id_space
        self._shared_ok: Optional[bool] = None
        self._pool = None
        self._pool_lock = threading.Lock()

    def _path_pool(self):
        """Lazy per-instance fan-out pool, grown if paths are added.

        Thread-safety contract (serving handles concurrent requests): the
        lock makes create/grow atomic, and an outgrown pool is NEVER shut
        down — a concurrent invoke may already hold it, and shutdown()
        would fail its map() with "cannot schedule new futures". Dropping
        the reference is enough: executor workers hold only a weakref to
        their executor, so GC of the old pool wakes and exits its idle
        threads (no leak), while in-flight work completes normally.
        """
        from concurrent.futures import ThreadPoolExecutor

        n = max(2, len(self.retrievers))
        with self._pool_lock:
            if self._pool is None or self._pool._max_workers < n:
                self._pool = ThreadPoolExecutor(
                    max_workers=n, thread_name_prefix="multipath"
                )
            return self._pool

    # -- mutation ---------------------------------------------------------

    def add_documents(self, documents: Sequence[Document], **kwargs: Any) -> List[str]:
        """Fan a corpus mutation out to every path that supports it.

        The reference's multipath has no mutation surface, but a hybrid
        serving deployment (dense + BM25 behind one endpoint) needs /add
        and /delete to hit ALL paths. Ids are assigned up front so every
        path stores the SAME id — each leaf would otherwise mint its own
        and a later delete would only reach one index. Paths without
        add_documents are skipped with a warning (a read-only path in the
        fan-out should not reject writes for the others).
        """
        import uuid

        docs = list(documents)
        for doc in docs:
            if not doc.id:
                doc.id = uuid.uuid4().hex
        ids = [doc.id for doc in docs]
        supported = 0
        for retriever in self.retrievers:
            add = getattr(retriever, "add_documents", None)
            if add is None:
                logger.warning(
                    "path %r does not support add_documents; skipping",
                    retriever.name,
                )
                continue
            add(docs, **kwargs)
            supported += 1
        if not supported:
            raise TypeError("no retrieval path supports add_documents")
        return ids

    def delete(self, ids: Sequence[str]) -> bool:
        """Delete ids from every path that supports deletes; True if any
        path deleted anything."""
        deleted = False
        for retriever in self.retrievers:
            delete = getattr(retriever, "delete", None)
            if delete is not None:
                deleted = bool(delete(ids)) or deleted
        return deleted

    # -- management -------------------------------------------------------

    def add_retriever(self, retriever: BaseRetriever) -> None:
        self.retrievers.append(retriever)

    def remove_retriever(self, name: str) -> bool:
        before = len(self.retrievers)
        self.retrievers = [r for r in self.retrievers if r.name != name]
        return len(self.retrievers) < before

    def set_fusion_method(self, fusion_method: FusionMethod) -> None:
        self.fusion_method = fusion_method

    # -- retrieval --------------------------------------------------------

    def _path_results(
        self, retriever: BaseRetriever, queries: Sequence[str], k: int
    ) -> List[List[RetrievalResult]]:
        """One path's per-query ranked results; failures → empty lists."""
        try:
            per_query = retriever.invoke_batch(queries, k=k)
        except Exception as exc:  # noqa: BLE001 — path isolation by contract
            logger.warning(
                "retrieval path %r failed (%s); continuing without it",
                retriever.name,
                exc,
            )
            return [[] for _ in queries]
        return [
            results_from_ranked_docs(docs, source=retriever.name)
            for docs in per_query
        ]

    def _get_relevant_documents(self, query: str, **kwargs: Any) -> List[Document]:
        return self._get_relevant_documents_batch([query], **kwargs)[0]

    # -- shared-id-space fast path -----------------------------------------

    def _shared_usable(self) -> bool:
        if not self.shared_id_space:
            return False
        if self._shared_ok is None:
            self._shared_ok = self._validate_shared()
        return self._shared_ok

    def _validate_shared(self) -> bool:
        """One-time check that the shared-id-space assertion plausibly
        holds: RRFusion fusion, every path speaks positions, equal space
        sizes, and a sampled position resolves to the SAME document id in
        every path. On failure: warn once, fall back to content fusion."""
        if not isinstance(self.fusion_method, RRFusion):
            logger.warning(
                "shared_id_space fusion requires RRFusion (got %s); "
                "falling back to content-keyed fusion",
                self.fusion_method.name(),
            )
            return False
        sizes = []
        for r in self.retrievers:
            if (
                getattr(r, "dispatch_positions", None) is None
                or getattr(r, "resolve_positions", None) is None
            ):
                logger.warning(
                    "shared_id_space: path %r has no position surface; "
                    "falling back to content-keyed fusion", r.name,
                )
                return False
            sizes.append(getattr(r, "position_space_size", None))
        if any(s is None for s in sizes) or len(set(sizes)) != 1 or not sizes[0]:
            logger.warning(
                "shared_id_space: position spaces disagree (%s); "
                "falling back to content-keyed fusion", sizes,
            )
            return False
        n = sizes[0]
        sample = [sorted({0, n // 2, n - 1})]
        ids_per_path = []
        for r in self.retrievers:
            docs = r.resolve_positions(np.asarray(sample))[0]
            if any(d is None for d in docs):
                logger.warning(
                    "shared_id_space: path %r cannot resolve sampled "
                    "positions; falling back to content-keyed fusion", r.name,
                )
                return False
            # compare CONTENT: independently-built paths over the same
            # corpus carry distinct auto-generated Document ids
            ids_per_path.append(tuple(d.content for d in docs))
        if len(set(ids_per_path)) != 1:
            logger.warning(
                "shared_id_space: sampled positions resolve to different "
                "documents across paths; falling back to "
                "content-keyed fusion",
            )
            return False
        return True

    def _dispatch_shared(
        self, queries: Sequence[str], per_path_k: int, top_k: int
    ) -> Optional["Callable[[], List[List[Document]]]"]:
        """Position-space fan-out: each path returns raw ``(B, k)``
        position arrays, fusion is one vectorized numpy RRF pass
        (bit-exact RRFusion parity), and ONLY the fused top-k documents
        materialize. This is what keeps the composed pipeline within a
        small factor of the raw kernels (content-keyed fusion spent
        ~30 ms/128-query batch building P·k_path Documents + dict RRF)."""
        _FAILED = object()
        fetches: List[Any] = []
        for r in self.retrievers:
            try:
                f = r.dispatch_positions(queries, k=per_path_k)
            except Exception as exc:  # noqa: BLE001 — path isolation
                logger.warning(
                    "retrieval path %r failed at dispatch (%s); continuing "
                    "without it", r.name, exc,
                )
                f = _FAILED
            if f is None:
                return None  # path lost its async surface mid-flight
            fetches.append(f)
        resolver = self.retrievers[0]
        rrf_k = self.fusion_method.k
        b = len(queries)

        def fetch() -> List[List[Document]]:
            mats: List[np.ndarray] = []
            for r, f in zip(self.retrievers, fetches):
                if f is _FAILED:
                    mats.append(np.full((b, per_path_k), -1, dtype=np.int64))
                    continue
                try:
                    _, p = f()
                    mats.append(np.asarray(p))
                except Exception as exc:  # noqa: BLE001 — path isolation
                    logger.warning(
                        "retrieval path %r failed (%s); continuing "
                        "without it", r.name, exc,
                    )
                    mats.append(np.full((b, per_path_k), -1, dtype=np.int64))
            fs, fp = rrf_fuse_positions_np(mats, top_k, rrf_k=rrf_k)
            doc_rows = resolver.resolve_positions(fp)
            out: List[List[Document]] = []
            for srow, docs in zip(fs, doc_rows):
                row: List[Document] = []
                for score, doc in zip(srow, docs):
                    if doc is None:
                        continue
                    d = Document(
                        content=doc.content,
                        metadata=dict(doc.metadata),
                        id=doc.id,
                    )
                    d.metadata["fusion_score"] = float(score)
                    row.append(d)
                out.append(row)
            return out

        def prime() -> None:
            for f in fetches:
                p = getattr(f, "prime", None)
                if p is not None and f is not _FAILED:
                    try:
                        p()
                    except Exception:  # noqa: BLE001 — fetch() reports it
                        pass

        fetch.prime = prime  # type: ignore[attr-defined]
        return fetch

    def dispatch_batch(
        self, queries: Sequence[str], **kwargs: Any
    ) -> Optional["Callable[[], List[List[Document]]]"]:
        """Async fan-out: every async-capable path dispatches NOW (device
        programs overlap each other and any host-side path work); fetch
        resolves all paths and fuses. Fusion uses ``RRFusion.fuse_ranked``
        when available — identical math to ``fuse`` without allocating
        2·B·k ``RetrievalResult`` wrappers per batch. Falls back to
        ``None`` (caller uses the sync path) only when NO path supports
        dispatch; a sync path inside a mixed fan-out computes at fetch
        time, after every async dispatch is already in flight."""
        top_k = int(kwargs.get("k", self.top_k))
        per_path_k = int(
            kwargs.get("top_k_per_retriever", self.top_k_per_retriever)
        )
        if self._shared_usable():
            fast = self._dispatch_shared(queries, per_path_k, top_k)
            if fast is not None:
                return fast
        _FAILED = object()  # dispatch-time failure → empty at fetch
        fetches: List[Any] = []
        any_async = False
        for r in self.retrievers:
            dispatch = getattr(r, "dispatch_batch", None)
            try:
                f = (
                    dispatch(queries, k=per_path_k)
                    if dispatch is not None else None
                )
            except Exception as exc:  # noqa: BLE001 — path isolation
                logger.warning(
                    "retrieval path %r failed at dispatch (%s); continuing "
                    "without it", r.name, exc,
                )
                f = _FAILED
            if f is not None and f is not _FAILED:
                any_async = True
            fetches.append(f)
        if not any_async:
            return None
        fuse_ranked = getattr(self.fusion_method, "fuse_ranked", None)

        def prime() -> None:
            # propagate lazy-launch to every async path (the BM25
            # device-query coalescer launches its merged kernel here)
            for f in fetches:
                p = getattr(f, "prime", None)
                if p is not None and f is not _FAILED:
                    try:
                        p()
                    except Exception:  # noqa: BLE001 — fetch() reports it
                        pass

        def fetch() -> List[List[Document]]:
            all_paths: List[List[List[Document]]] = []
            for r, f in zip(self.retrievers, fetches):
                try:
                    if f is _FAILED:
                        all_paths.append([[] for _ in queries])
                    elif f is not None:
                        all_paths.append(f())
                    else:
                        all_paths.append(
                            r.invoke_batch(queries, k=per_path_k)
                        )
                except Exception as exc:  # noqa: BLE001 — path isolation
                    logger.warning(
                        "retrieval path %r failed (%s); continuing "
                        "without it", r.name, exc,
                    )
                    all_paths.append([[] for _ in queries])
            fused: List[List[Document]] = []
            for qi in range(len(queries)):
                per_query = [path[qi] for path in all_paths]
                if fuse_ranked is not None:
                    fused.append(fuse_ranked(per_query, top_k))
                else:
                    fused.append(
                        self.fusion_method.fuse(
                            [
                                results_from_ranked_docs(
                                    docs, source=r.name
                                )
                                for r, docs in zip(self.retrievers, per_query)
                            ],
                            top_k,
                        )
                    )
            return fused

        fetch.prime = prime  # type: ignore[attr-defined]
        return fetch

    def _get_relevant_documents_batch(
        self, queries: Sequence[str], **kwargs: Any
    ) -> List[List[Document]]:
        top_k = int(kwargs.get("k", self.top_k))
        per_path_k = int(kwargs.get("top_k_per_retriever", self.top_k_per_retriever))
        if self._shared_usable():
            fast = self._dispatch_shared(queries, per_path_k, top_k)
            if fast is not None:
                return fast()
        if len(self.retrievers) <= 1:
            all_paths = [
                self._path_results(r, queries, per_path_k)
                for r in self.retrievers
            ]
        else:
            # paths overlap: a dense path is a device dispatch that mostly
            # *waits* (device program + result fetch) while a BM25 path is host
            # CPU work — fanning out makes a hybrid query cost max(paths),
            # not sum(paths). A lazy per-instance pool avoids per-request
            # thread spawn AND the deadlock a shared pool invites when
            # ainvoke (which runs on that shared pool) calls into here.
            # _path_results isolates per-path failures.
            all_paths = list(
                self._path_pool().map(
                    lambda r: self._path_results(r, queries, per_path_k),
                    self.retrievers,
                )
            )
        fused: List[List[Document]] = []
        for qi in range(len(queries)):
            per_query_paths = [path[qi] for path in all_paths]
            fused.append(self.fusion_method.fuse(per_query_paths, top_k))
        return fused

    # -- introspection -----------------------------------------------------

    def get_info(self) -> dict:
        return {
            "retrievers": [r.name for r in self.retrievers],
            "fusion": self.fusion_method.name(),
            "top_k": self.top_k,
            "top_k_per_retriever": self.top_k_per_retriever,
        }
