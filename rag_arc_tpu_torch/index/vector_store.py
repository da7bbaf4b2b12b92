"""Vector store API surface + device-backed implementation (counterpart of
``rag_arc_tpu/index/vector_store.py``).

``VectorStore`` is the retriever-facing contract: add / delete /
get_by_ids, the ``similarity_search*`` family, relevance-score
normalization, ``from_texts``/``from_documents`` and ``as_retriever``.

``TorchVectorStore`` keeps vectors in an index chosen by ``index_type``:
a ``DeviceFlatIndex`` on the card ("flat", and "auto"), a
``DeviceIVFIndex`` ("ivf": rows stage in a flat index until
``train_threshold`` of them exist, then k-means trains the lists), or the
host C++ ``HNSWIndex`` ("hnsw"). Documents live in a host ``Docstore``
(or, with ``docstore_path``, the disk-backed ``BlobDocstore``). Deletes
tombstone; ``compact()`` reclaims space. MMR gathers its candidates'
vectors from the index (``take``) and selects on the host
(``ops/mmr.py``). On a flat index the batched query path chains the
encoder forward into the search on the device: token ids go up, one
(scores, positions) readback comes down; IVF and HNSW take numpy queries
and answer numpy, as in the JAX package.
"""

from __future__ import annotations

import asyncio
import logging
import math
import warnings
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rag_arc_tpu_torch.models.embeddings import Embeddings
from rag_arc_tpu_torch.utils.data_model import Document
from rag_arc_tpu_torch.utils.locks import RWLock
from rag_arc_tpu_torch.utils.tracing import get_tracer, stage  # noqa: F401 (re-exported: the store's spans)
from rag_arc_tpu_torch.index.docstore import Docstore
from rag_arc_tpu_torch.index.flat import DeviceFlatIndex, normalize_raw, pair_readback
from rag_arc_tpu_torch.index.ivf import DeviceIVFIndex
from rag_arc_tpu_torch.ops.mmr import mmr_select

logger = logging.getLogger(__name__)

_EXECUTOR: Optional[ThreadPoolExecutor] = None


def _executor() -> ThreadPoolExecutor:
    global _EXECUTOR
    if _EXECUTOR is None:
        _EXECUTOR = ThreadPoolExecutor(max_workers=4, thread_name_prefix="vstore")
    return _EXECUTOR


class VectorStore(ABC):
    """Abstract vector store: the retriever-facing contract."""

    # -- abstract primitives ---------------------------------------------

    @abstractmethod
    def add_documents(
        self, documents: Sequence[Document], ids: Optional[Sequence[str]] = None
    ) -> List[str]: ...

    @abstractmethod
    def delete(self, ids: Sequence[str]) -> bool: ...

    @abstractmethod
    def get_by_ids(self, ids: Sequence[str]) -> List[Document]: ...

    @abstractmethod
    def similarity_search_with_score(
        self, query: str, k: int = 4, **kwargs: Any
    ) -> List[Tuple[Document, float]]: ...

    @abstractmethod
    def similarity_search_by_vector_with_score(
        self, embedding: Sequence[float], k: int = 4, **kwargs: Any
    ) -> List[Tuple[Document, float]]: ...

    @abstractmethod
    def max_marginal_relevance_search(
        self,
        query: str,
        k: int = 4,
        fetch_k: int = 20,
        lambda_mult: float = 0.5,
        **kwargs: Any,
    ) -> List[Document]: ...

    # -- derived surface --------------------------------------------------

    def add_texts(
        self,
        texts: Sequence[str],
        metadatas: Optional[Sequence[dict]] = None,
        ids: Optional[Sequence[str]] = None,
    ) -> List[str]:
        metadatas = metadatas or [{} for _ in texts]
        if len(metadatas) != len(texts):
            raise ValueError("texts and metadatas length mismatch")
        docs = [
            Document(content=t, metadata=dict(m)) for t, m in zip(texts, metadatas)
        ]
        return self.add_documents(docs, ids=ids)

    def similarity_search(self, query: str, k: int = 4, **kwargs: Any) -> List[Document]:
        return [doc for doc, _ in self.similarity_search_with_score(query, k, **kwargs)]

    def similarity_search_by_vector(
        self, embedding: Sequence[float], k: int = 4, **kwargs: Any
    ) -> List[Document]:
        return [
            doc
            for doc, _ in self.similarity_search_by_vector_with_score(
                embedding, k, **kwargs
            )
        ]

    def similarity_search_with_relevance_scores(
        self,
        query: str,
        k: int = 4,
        score_threshold: Optional[float] = None,
        **kwargs: Any,
    ) -> List[Tuple[Document, float]]:
        """Scores normalized to [0, 1]; optionally filtered by threshold,
        with the out-of-range and empty-result warnings."""
        norm = self._relevance_score_fn()
        raw = self.similarity_search_with_score(query, k, **kwargs)
        scored = [(doc, norm(score)) for doc, score in raw]
        eps = 1e-5  # float32 rounding can nudge a perfect match past 1.0
        if scored and any(s < -eps or s > 1.0 + eps for _, s in scored):
            warnings.warn(
                "relevance scores outside [0, 1]; check the metric/normalizer "
                f"pairing (got {[round(s, 4) for _, s in scored]})"
            )
        if getattr(self, "metric", "cosine") in ("cosine", "l2"):
            scored = [(d, min(max(s, 0.0), 1.0)) for d, s in scored]
        if score_threshold is not None:
            scored = [(d, s) for d, s in scored if s >= score_threshold]
            if not scored:
                warnings.warn(
                    f"no documents with relevance >= {score_threshold} for query"
                )
        return scored

    def search(self, query: str, search_type: str = "similarity", **kwargs: Any):
        if search_type == "similarity":
            return self.similarity_search(query, **kwargs)
        if search_type == "similarity_score_threshold":
            return [d for d, _ in self.similarity_search_with_relevance_scores(query, **kwargs)]
        if search_type == "mmr":
            return self.max_marginal_relevance_search(query, **kwargs)
        raise ValueError(
            f"search_type must be 'similarity', 'similarity_score_threshold' "
            f"or 'mmr', got {search_type!r}"
        )

    def as_retriever(self, **kwargs: Any):
        from rag_arc_tpu_torch.retrieval.dense import VectorStoreRetriever

        return VectorStoreRetriever(vectorstore=self, **kwargs)

    # -- async shims ------------------------------------------------------

    async def aadd_documents(self, documents, ids=None):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            _executor(), lambda: self.add_documents(documents, ids)
        )

    async def aadd_texts(self, texts, metadatas=None, ids=None):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            _executor(), lambda: self.add_texts(texts, metadatas, ids)
        )

    async def asimilarity_search(self, query: str, k: int = 4, **kwargs: Any):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            _executor(), lambda: self.similarity_search(query, k, **kwargs)
        )

    async def asimilarity_search_with_score(self, query: str, k: int = 4, **kwargs: Any):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            _executor(), lambda: self.similarity_search_with_score(query, k, **kwargs)
        )

    # -- classmethod constructors ----------------------------------------

    @classmethod
    def from_texts(
        cls,
        texts: Sequence[str],
        embedding: Embeddings,
        metadatas: Optional[Sequence[dict]] = None,
        ids: Optional[Sequence[str]] = None,
        **kwargs: Any,
    ) -> "VectorStore":
        store = cls(embedding=embedding, **kwargs)  # type: ignore[call-arg]
        store.add_texts(texts, metadatas=metadatas, ids=ids)
        return store

    @classmethod
    def from_documents(
        cls, documents: Sequence[Document], embedding: Embeddings, **kwargs: Any
    ) -> "VectorStore":
        store = cls(embedding=embedding, **kwargs)  # type: ignore[call-arg]
        store.add_documents(documents)
        return store

    # -- relevance normalization ------------------------------------------

    def _relevance_score_fn(self) -> Callable[[float], float]:
        """Map raw metric scores to [0, 1] relevance."""
        metric = getattr(self, "metric", "cosine")
        if metric == "cosine":
            return lambda s: (s + 1.0) / 2.0
        if metric == "l2":
            # index returns negative squared distance
            return lambda s: 1.0 / (1.0 + max(0.0, -s))
        # inner product has no bounded normalization
        return lambda s: s


class TorchVectorStore(VectorStore):
    """Vector store over a flat, IVF or HNSW index (``index_type``).

    ``dtype=torch.int8`` stores block-quantized int8 rows (flat), int8
    residual codes (IVF) or selects SQ8 storage (HNSW); ``refine``
    (``"default"``, None, ``"int4"``, ``"int8"``), ``kf_mult`` and
    ``rescore_i8`` pass through to the flat index (see ``index/flat.py``).
    ``nlist``, ``nprobe``, ``ivf_spill``, ``ivf_spill_cap`` and
    ``train_threshold`` (default ``max(100, nlist)``) configure IVF;
    ``hnsw_pq_m`` > 0 selects product-quantized HNSW and
    ``hnsw_pq_refine`` its SQ8 rescore copy. ``docstore_path`` keeps
    document content on disk in a ``BlobDocstore`` there (mmap reads,
    bounded host RAM) for large corpora."""

    def __init__(
        self,
        embedding: Embeddings,
        dim: Optional[int] = None,
        metric: str = "cosine",
        capacity: int = 4096,
        dtype: Optional[torch.dtype] = None,
        compact_threshold: float = 0.5,
        *,
        device: torch.device | str,
        refine: Optional[str] = "default",
        kf_mult: int = 2,
        rescore_i8: bool = True,
        docstore_path: Optional[str] = None,
        index_type: str = "flat",
        nlist: int = 100,
        nprobe: int = 8,
        ivf_spill: int = 1,
        ivf_spill_cap: float = 1.25,
        train_threshold: Optional[int] = None,
        hnsw_pq_m: int = 0,
        hnsw_pq_refine: bool = False,
    ):
        if index_type == "auto":
            # the JAX package's auto policy: flat. Its rationale is a TPU
            # measurement (flat beat IVF's best QPS on a clustered 1M
            # corpus); opt in to 'ivf' or 'hnsw' explicitly
            index_type = "flat"
        if index_type not in ("flat", "ivf", "hnsw"):
            raise ValueError(
                f"index_type must be 'auto', 'flat', 'ivf' or 'hnsw', "
                f"got {index_type!r}"
            )
        # the IVF index is built mid-add at auto-train time: refuse its
        # int8 + l2 combination now, not with documents half recorded
        if index_type == "ivf" and dtype == torch.int8 and metric == "l2":
            raise ValueError("int8 IVF storage supports cosine/ip, not l2")
        self.embedding = embedding
        self.metric = metric
        self.device = torch.device(device)
        # searches run concurrently; mutation is exclusive
        self._rw = RWLock()
        self._init_capacity = capacity
        self._dtype = dtype
        if docstore_path is not None:
            from rag_arc_tpu_torch.index.blob_docstore import BlobDocstore

            self.docstore = BlobDocstore(docstore_path)
        else:
            self.docstore = Docstore()
        self.index: Optional[DeviceFlatIndex] = None
        self.compact_threshold = compact_threshold
        # int8 residual-refinement ladder; "default" keeps the index's
        # default (int4, or int8 at odd dims), None disables the sidecar
        self.refine = refine
        # int8 candidate over-fetch multiplier (search-time knob)
        self.kf_mult = int(kf_mult)
        self.rescore_i8 = bool(rescore_i8)
        self.index_type = index_type
        self.nlist = nlist
        self.nprobe = nprobe
        self.ivf_spill = int(ivf_spill)
        self.ivf_spill_cap = float(ivf_spill_cap)
        # rows accumulate in a flat index until the IVF can be trained
        self.train_threshold = train_threshold or max(100, nlist)
        self.hnsw_pq_m = int(hnsw_pq_m)
        self.hnsw_pq_refine = bool(hnsw_pq_refine)
        self._dim = dim or getattr(embedding, "dim", None)
        if self._dim is not None:
            self._create_index(self._dim)

    def _create_index(self, dim: int) -> None:
        """Lazy index creation at first add: 'flat' and (pre-train) 'ivf'
        start as a DeviceFlatIndex; 'hnsw' is the host C++ engine."""
        # the residual ladder exists only on the int8 flat index: an
        # explicitly requested refine that cannot apply warns
        if self.refine not in ("default", None) and (
            self.index_type != "flat" or self._dtype != torch.int8
        ):
            logger.warning(
                "refine=%r has no effect on index_type=%r dtype=%r — the "
                "residual ladder needs index_type='flat' and dtype=int8 "
                "(hnsw recall guard is hnsw_pq_refine)",
                self.refine, self.index_type, self._dtype,
            )
        if self.index_type == "hnsw":
            from rag_arc_tpu_torch.index.hnsw import HNSWIndex

            # dtype=int8 selects SQ8 storage inside the C++ engine
            self.index = HNSWIndex(
                dim=dim,
                metric=self.metric,
                quantize=self.hnsw_pq_m == 0 and self._dtype == torch.int8,
                pq_m=self.hnsw_pq_m,
                pq_refine=self.hnsw_pq_refine,
            )
            self._dim = dim
            return
        self.index = DeviceFlatIndex(
            dim=dim,
            metric=self.metric,
            capacity=self._init_capacity,
            dtype=self._dtype or torch.float32,
            device=self.device,
            refine=self.refine,
            kf_mult=self.kf_mult,
            rescore_i8=self.rescore_i8,
        )
        self._dim = dim

    # -- mutation ---------------------------------------------------------

    def add_documents(
        self, documents: Sequence[Document], ids: Optional[Sequence[str]] = None
    ) -> List[str]:
        documents = list(documents)
        if ids is not None:
            if len(ids) != len(documents):
                raise ValueError("ids and documents length mismatch")
            for doc, doc_id in zip(documents, ids):
                doc.id = doc_id
        if not documents:
            return []
        # embed in bounded chunks so a large ingest never materializes one
        # giant activation batch
        contents = [d.content for d in documents]
        chunk = 4096
        vectors = np.concatenate(
            [
                self.embedding.encode(contents[i : i + chunk])
                for i in range(0, len(contents), chunk)
            ]
        )
        # embedding runs outside the write lock so a slow encoder doesn't
        # block in-flight queries; only the index/docstore mutation needs it
        with self._rw.write():
            if self.index is None:
                self._create_index(vectors.shape[1])
            # within-batch duplicate ids: keep the LAST occurrence, or an
            # earlier copy would stay live, searchable and unresolvable
            last = {d.id: i for i, d in enumerate(documents) if d.id is not None}
            if any(
                d.id is not None and last[d.id] != i
                for i, d in enumerate(documents)
            ):
                keep = [
                    i for i, d in enumerate(documents)
                    if d.id is None or last[d.id] == i
                ]
                documents = [documents[i] for i in keep]
                vectors = vectors[keep]
            # overwrite semantics for duplicate ids: tombstone the old rows
            stale = [
                p
                for d in documents
                if d.id is not None
                and (p := self.docstore.position_of(d.id)) is not None
            ]
            if stale:
                self.index.mark_deleted(np.asarray(stale))
            positions = self.index.add(vectors)
            # record BEFORE auto-train: training may compact the index,
            # and the remap must find these rows' positions
            ids = self.docstore.add(documents, positions.tolist())
            self._maybe_train_ivf()
            return ids

    def _maybe_train_ivf(self) -> None:
        """Convert the staging flat index to IVF once enough rows exist.
        Positions carry over 1:1, so the docstore mapping holds."""
        if (
            self.index_type != "ivf"
            or not isinstance(self.index, DeviceFlatIndex)
            or self.index.size < self.train_threshold
        ):
            return
        flat = self.index
        if flat.n_deleted or flat._gap_rows:
            # compact first so k-means never trains on tombstoned rows or
            # int8 block-alignment gap rows; positions remap through the
            # docstore like any compaction
            self.docstore.reassign(flat.compact())
        # compaction leaves the live rows as a contiguous prefix (int8
        # re-creates at most one tail gap block)
        n_live = flat.size - flat._gap_rows
        vectors = flat.emb[:n_live].float()
        if flat.quantized:
            # staging rows are int8 codes: dequantize through the rows'
            # scales (the flat index's sqnorm column in int8 mode), as the
            # JAX package does
            vectors = vectors * flat.sqnorm[:n_live, None]
        logger.info("training IVF (nlist=%d) over %d rows", self.nlist, n_live)
        self.index = DeviceIVFIndex.from_vectors(
            vectors.cpu().numpy(),
            nlist=self.nlist,
            nprobe=self.nprobe,
            metric=self.metric,
            dtype=self._dtype or torch.float32,
            spill=self.ivf_spill,
            spill_cap=self.ivf_spill_cap,
            device=self.device,
        )

    def delete(self, ids: Sequence[str]) -> bool:
        with self._rw.write():
            freed = self.docstore.delete(ids)
            if not freed:
                return False
            self.index.mark_deleted(np.asarray(freed))
            if (
                hasattr(self.index, "compact")
                and self.index.size > 0
                and self.index.n_deleted / self.index.size > self.compact_threshold
            ):
                self._compact_locked()
            return True

    def compact(self) -> None:
        with self._rw.write():
            self._compact_locked()

    def _compact_locked(self) -> None:
        self.docstore.reassign(self.index.compact())

    def get_by_ids(self, ids: Sequence[str]) -> List[Document]:
        return self.docstore.get_by_ids(ids)

    # -- search -----------------------------------------------------------

    def _resolve(
        self, scores: np.ndarray, positions: np.ndarray
    ) -> List[Tuple[Document, float]]:
        out: List[Tuple[Document, float]] = []
        for score, pos in zip(scores, positions):
            if pos < 0:
                continue
            doc = self.docstore.get_by_position(int(pos))
            if doc is not None:
                out.append((doc, float(score)))
        return out

    def similarity_search_with_score(
        self, query: str, k: int = 4, **kwargs: Any
    ) -> List[Tuple[Document, float]]:
        vec = self.embedding.encode([query])[0]
        return self.similarity_search_by_vector_with_score(vec, k, **kwargs)

    def similarity_search_by_vector_with_score(
        self, embedding: Sequence[float], k: int = 4, **kwargs: Any
    ) -> List[Tuple[Document, float]]:
        if self.index is None or self.index.n_active == 0:
            return []
        q = np.asarray(embedding, dtype=np.float32).reshape(1, -1)
        with self._rw.read():
            scores, positions = self.index.search(q, k)
            return self._resolve(scores[0], positions[0])

    def batch_similarity_search_with_score(
        self, queries: Sequence[str], k: int = 4
    ) -> List[List[Tuple[Document, float]]]:
        """Batched entry: one device dispatch for many queries. With a
        device embedder (``encode_device``) the encoder forward chains
        straight into the index search on the device."""
        if self.index is None or self.index.n_active == 0 or not queries:
            return [[] for _ in queries]
        with self._rw.read():
            scores, positions = self._dispatch_search_raw(list(queries), k)()
            return [self._resolve(s, p) for s, p in zip(scores, positions)]

    def dispatch_batch_search(
        self, queries: Sequence[str], k: int = 4
    ) -> Callable[[], List[List[Tuple[Document, float]]]]:
        """Async variant of :meth:`batch_similarity_search_with_score`:
        enqueues the device work and returns a ``fetch`` callable that does
        the one readback and resolves Documents."""
        if self.index is None or self.index.n_active == 0 or not queries:
            empty = [[] for _ in queries]
            return lambda: empty
        with self._rw.read():
            fetch_raw = self._dispatch_search_raw(list(queries), k)

        def fetch() -> List[List[Tuple[Document, float]]]:
            scores, positions = fetch_raw()
            return [self._resolve(s, p) for s, p in zip(scores, positions)]

        return fetch

    def dispatch_search_raw(
        self, queries: Sequence[str], k: int = 4
    ) -> Callable[[], Tuple[np.ndarray, np.ndarray]]:
        """Raw-positions async search: fetch returns ``(scores (B, k),
        positions (B, k))`` with -inf/-1 padding and no Documents."""
        if self.index is None or self.index.n_active == 0 or not queries:
            b = len(queries)
            out = (
                np.full((b, k), -np.inf, dtype=np.float32),
                np.full((b, k), -1, dtype=np.int64),
            )
            return lambda: out
        with self._rw.read():
            return self._dispatch_search_raw(list(queries), k)

    def resolve_positions(
        self, rows: np.ndarray
    ) -> List[List[Optional[Document]]]:
        """Slot-aligned Document lookup for raw position rows: ``None`` for
        -1 / missing positions."""
        return [
            [
                self.docstore.get_by_position(int(p)) if p >= 0 else None
                for p in row
            ]
            for row in rows
        ]

    @property
    def position_space_size(self) -> int:
        return len(self.docstore)

    def _dispatch_search_raw(
        self, queries: List[str], k: int
    ) -> Callable[[], Tuple[np.ndarray, np.ndarray]]:
        encode_device = getattr(self.embedding, "encode_device", None)
        search_device = getattr(self.index, "search_device", None)
        tokenizer = getattr(self.embedding, "tokenizer", None)
        if encode_device is None or search_device is None or tokenizer is None:
            vecs = np.asarray(self.embedding.encode(queries))
            dispatch = getattr(self.index, "search_dispatch", None)
            if dispatch is not None:
                # host embedder, flat index: enqueue the device search
                # now, defer the readback
                return dispatch(vecs, k)
            out = self.index.search(vecs, k)  # IVF / HNSW: numpy in and out
            return lambda: out

        # chained hot path, three host<->device events: upload (ids, mask),
        # encode -> search on the device, one readback of (scores, positions)
        with stage("store.tokenize"):
            cleaned = [t.replace("\n", " ") for t in queries]
            ids, mask = tokenizer.batch_encode(cleaned)
            length = self.embedding._bucket_len(ids.shape[1])
            if length > ids.shape[1]:
                pad = length - ids.shape[1]
                ids = np.pad(ids, ((0, 0), (0, pad)))
                mask = np.pad(mask, ((0, 0), (0, pad)))
            elif length < ids.shape[1]:
                ids, mask = ids[:, :length], mask[:, :length]
            b = len(queries)
            b_pad = 1 << math.ceil(math.log2(max(b, 1)))
            if b_pad > b:
                ids = np.pad(ids, ((0, b_pad - b), (0, 0)))
                mask = np.pad(mask, ((0, b_pad - b), (0, 0)))
        k_eff = min(k, self.index.capacity)
        with stage("store.dispatch"):
            ids_dev = torch.from_numpy(ids).to(self.device)
            mask_dev = torch.from_numpy(mask).to(self.device)
            q_dev = encode_device(ids_dev, mask_dev)
            s_dev, p_dev = search_device(q_dev, k_eff)
        # under an active TransferPool the pair rides the stream's one flush
        readback = pair_readback(s_dev, p_dev)

        def fetch_chained() -> Tuple[np.ndarray, np.ndarray]:
            with stage("store.fetch"):
                s_host, p_host = readback()
            return normalize_raw(s_host, p_host, b, k, k_eff)

        return fetch_chained

    def multi_query_search(
        self,
        variants_per_query: Sequence[Sequence[str]],
        k: int = 10,
        k_per_variant: int = 20,
        rrf_k: int = 60,
    ) -> List[List[Tuple[Document, float]]]:
        """Fused multi-query fan-out: every variant of every query answers
        in ONE batched search, and the per-variant rankings fuse with RRF
        over positions (``ops/fusion_kernel.py``); candidates resolve to
        Documents only after fusion. The positions are on the host after
        the search's one readback, so the fusion runs there, in torch."""
        from rag_arc_tpu_torch.ops.fusion_kernel import rrf_fuse_positions

        if self.index is None or self.index.n_active == 0:
            return [[] for _ in variants_per_query]
        flat_queries = [v for vs in variants_per_query for v in vs]
        if not flat_queries:
            return [[] for _ in variants_per_query]
        with self._rw.read():
            # resolution must stay under the read lock: a concurrent
            # delete can cross compact_threshold and remap positions
            _, positions = self._dispatch_search_raw(flat_queries, k_per_variant)()
            b = len(variants_per_query)
            p_max = max(len(vs) for vs in variants_per_query)
            grouped = np.full((b, p_max, k_per_variant), -1, dtype=np.int32)
            row = 0
            for qi, vs in enumerate(variants_per_query):
                for pi in range(len(vs)):
                    grouped[qi, pi] = positions[row]
                    row += 1
            scores, fused = rrf_fuse_positions(torch.from_numpy(grouped), k_out=k, rrf_k=rrf_k)
            return [self._resolve(s, p) for s, p in zip(scores.numpy(), fused.numpy())]

    def max_marginal_relevance_search(
        self,
        query: str,
        k: int = 4,
        fetch_k: int = 20,
        lambda_mult: float = 0.5,
        **kwargs: Any,
    ) -> List[Document]:
        vec = np.asarray(self.embedding.encode([query])[0])
        return self.max_marginal_relevance_search_by_vector(
            vec, k=k, fetch_k=fetch_k, lambda_mult=lambda_mult
        )

    def max_marginal_relevance_search_by_vector(
        self,
        embedding: Sequence[float],
        k: int = 4,
        fetch_k: int = 20,
        lambda_mult: float = 0.5,
    ) -> List[Document]:
        if self.index is None or self.index.n_active == 0:
            return []
        q = np.asarray(embedding, dtype=np.float32).reshape(1, -1)
        with self._rw.read():
            _, positions = self.index.search(q, fetch_k)
            cand_pos = positions[0][positions[0] >= 0]
            if cand_pos.size == 0:
                return []
            cand_vecs = self.index.take(cand_pos)
            # select AND resolve under the lock: a concurrent compaction
            # would remap positions out from under cand_pos
            chosen = mmr_select(q[0], cand_vecs, k=k, lambda_mult=lambda_mult)
            docs = []
            for i in chosen:
                doc = self.docstore.get_by_position(int(cand_pos[i]))
                if doc is not None:
                    docs.append(doc)
            return docs

    # -- introspection ----------------------------------------------------

    def get_vectorstore_info(self) -> Dict[str, Any]:
        info: Dict[str, Any] = {
            "type": type(self).__name__,
            "metric": self.metric,
            "num_documents": len(self.docstore),
            "embedding": type(self.embedding).__name__,
        }
        if self.index is not None:
            info["index"] = self.index.stats()
        return info

    def __len__(self) -> int:
        return len(self.docstore)
