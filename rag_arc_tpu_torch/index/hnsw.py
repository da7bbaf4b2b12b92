"""HNSW index (host C++ behind ctypes; counterpart of
``rag_arc_tpu/index/hnsw.py``).

Capability parity with FAISS ``IndexHNSWFlat`` (M=32), implemented in
``native/hnsw.cpp``, a byte-identical copy of the JAX package's engine,
built by ``native/build.py`` into ``rag_arc_tpu_torch/_build/native/``.
It presents the device indexes' interface (add / search / mark_deleted /
take / stats) so ``TorchVectorStore`` treats all three index types
uniformly. The graph has no device code: it is the host path for
latency-critical single-query traffic. ``hnsw.bin`` snapshots are the
engine's own format, so either package loads the other's.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from rag_arc_tpu_torch.native.build import load_library

_METRIC_CODE = {"cosine": 0, "ip": 0, "l2": 1}


def _bind():
    lib = load_library("hnsw")
    lib.hnsw_create.restype = ctypes.c_void_p
    lib.hnsw_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
    ]
    lib.hnsw_is_quantized.restype = ctypes.c_int
    lib.hnsw_is_quantized.argtypes = [ctypes.c_void_p]
    lib.hnsw_pq_m.restype = ctypes.c_int
    lib.hnsw_pq_m.argtypes = [ctypes.c_void_p]
    lib.hnsw_is_trained.restype = ctypes.c_int
    lib.hnsw_is_trained.argtypes = [ctypes.c_void_p]
    lib.hnsw_train_pq.restype = ctypes.c_int
    lib.hnsw_train_pq.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    lib.hnsw_free.argtypes = [ctypes.c_void_p]
    lib.hnsw_add.restype = ctypes.c_int64
    lib.hnsw_add.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.hnsw_search.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.hnsw_mark_deleted.restype = ctypes.c_int64  # rows NEWLY tombstoned
    lib.hnsw_mark_deleted.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    lib.hnsw_size.restype = ctypes.c_int64
    lib.hnsw_size.argtypes = [ctypes.c_void_p]
    lib.hnsw_count_deleted.restype = ctypes.c_int64
    lib.hnsw_count_deleted.argtypes = [ctypes.c_void_p]
    lib.hnsw_get_vector.restype = ctypes.c_int  # -1 = out-of-range id
    lib.hnsw_get_vector.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
    ]
    lib.hnsw_save.restype = ctypes.c_int
    lib.hnsw_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.hnsw_load.restype = ctypes.c_void_p
    lib.hnsw_load.argtypes = [ctypes.c_char_p]
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class _RefineStore:
    """Append-only SQ8 row store (symmetric per-row scale): the exact-
    rescore sidecar for PQ refine. Positions mirror the graph's."""

    def __init__(self, dim: int):
        self.dim = dim
        self.n = 0
        self.codes = np.empty((0, dim), dtype=np.int8)
        self.scales = np.empty((0,), dtype=np.float32)

    def append(self, rows: np.ndarray) -> None:
        # the ONE symmetric per-row int8 encode (ops/two_level.py, numpy,
        # bit-equal to the JAX package's)
        from rag_arc_tpu_torch.ops.two_level import quantize_rows

        codes, scales = quantize_rows(rows)
        need = self.n + rows.shape[0]
        if need > self.codes.shape[0]:
            cap = max(1024, 1 << int(np.ceil(np.log2(need))))
            new_codes = np.empty((cap, self.dim), dtype=np.int8)
            new_scales = np.empty((cap,), dtype=np.float32)
            new_codes[: self.n] = self.codes[: self.n]
            new_scales[: self.n] = self.scales[: self.n]
            self.codes, self.scales = new_codes, new_scales
        self.codes[self.n : need] = codes
        self.scales[self.n : need] = scales
        self.n = need

    def decode(self, positions: np.ndarray) -> np.ndarray:
        pos = np.clip(positions, 0, max(self.n - 1, 0))
        return (
            self.codes[pos].astype(np.float32)
            * self.scales[pos][..., None]
        )


class HNSWIndex:
    def __init__(
        self,
        dim: int,
        metric: str = "cosine",
        M: int = 32,
        ef_construction: int = 200,
        ef_search: int = 64,
        seed: int = 0,
        quantize: bool = False,
        pq_m: int = 0,
        pq_train_threshold: int = 4096,
        pq_refine: bool = False,
        _handle: Optional[int] = None,
    ):
        if metric not in _METRIC_CODE:
            raise ValueError(f"metric must be one of {sorted(_METRIC_CODE)}")
        if quantize and pq_m:
            raise ValueError("choose ONE of quantize (sq8) and pq_m (pq)")
        if pq_m and dim % pq_m != 0:
            raise ValueError(f"pq_m must divide dim ({dim} % {pq_m} != 0)")
        self._lib = _bind()
        self.dim = dim
        self.metric = metric
        self.M = M
        self.ef_construction = ef_construction
        self.ef_search = ef_search
        # SQ8: vectors store as per-vector-scaled symmetric int8 inside the
        # C++ engine — 4x less resident memory than f32 (FAISS IndexHNSWSQ
        # parity); graph traversal and scores use the quantized metric
        self.quantize = bool(quantize)
        # PQ: pq_m bytes/vector via product-quantization codebooks (FAISS
        # IndexHNSWPQ parity: m sub-spaces x 256 centroids; dim=768 m=96 →
        # 32x less resident memory than f32). Codebooks need training, so
        # vectors STAGE on the host until pq_train_threshold rows arrive;
        # staged search is a brute-force scan (tiny n), mirroring the
        # flat→IVF auto-train pattern (VectorStore_Faiss.py:181-184).
        # Measured recall caveat (the JAX package's tools/hnsw_bench.py, on
        # the same host engine): the graph+ADC machinery recovers ~0.93 of
        # the QUANTIZED metric's top-10, but on near-duplicate corpora
        # (query twins inside tight clusters) the quantizer itself cannot
        # separate twins — recall@10 vs exact
        # fell to 0.19 (d=256) / 0.11 (d=768, m=96) at dsub=8, where SQ8
        # held 0.97/0.93 on the same corpora. This is inherent to pure
        # ADC (FAISS IndexHNSWPQ shares it), not a machinery bug. PQ is
        # for memory-bound corpora whose neighbors aren't near-
        # duplicates; prefer dtype=int8 (SQ8) when recall matters.
        self.pq_m = int(pq_m)
        self.pq_train_threshold = max(256, int(pq_train_threshold))
        # PQ refine (FAISS IndexRefine parity): keep an SQ8 copy of every
        # row on the host (dim + 4 bytes/row); search widens the graph
        # candidate set and rescores it against the SQ8 copy. Recovers
        # SQ8-level recall from a PQ-coded graph at ~4x-less-than-f32
        # memory (vs PQ-alone's 32x) — the guard rail for the measured
        # near-duplicate recall cliff documented above.
        self.pq_refine = bool(pq_refine) and bool(pq_m)
        self._refine = _RefineStore(dim) if self.pq_refine else None
        if pq_m and not self.pq_refine and dim // pq_m >= 4:
            import warnings

            warnings.warn(
                f"PQ at dsub={dim // pq_m} floats/sub-space can cost "
                f"substantial recall on corpora with near-duplicate "
                f"neighbors (measured: recall@10 0.64 at dsub=4 on a "
                f"gaussian worst case). Pass pq_refine=True to rescore "
                f"candidates against an SQ8 copy (+{dim + 4} bytes/row), "
                f"or use quantize=True (SQ8) if memory allows",
                stacklevel=2,
            )
        self._staged: list[np.ndarray] = []
        self._staged_deleted: set[int] = set()
        self.n_deleted = 0
        quant = 2 if pq_m else (1 if quantize else 0)
        self._handle = _handle if _handle is not None else self._lib.hnsw_create(
            dim, M, ef_construction, _METRIC_CODE[metric], seed, quant, pq_m,
        )
        if not self._handle:
            raise ValueError("hnsw_create rejected the configuration")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.hnsw_free(handle)
            self._handle = None

    # -- interface shared with the device indexes ---------------------------

    def _prep(self, vectors: np.ndarray) -> np.ndarray:
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if self.metric == "cosine":
            vectors = vectors / np.maximum(
                np.linalg.norm(vectors, axis=1, keepdims=True), 1e-12
            )
            vectors = np.ascontiguousarray(vectors)
        return vectors

    @property
    def _trained(self) -> bool:
        return bool(self._lib.hnsw_is_trained(self._handle))

    def add(self, vectors: np.ndarray) -> np.ndarray:
        vectors = self._prep(np.atleast_2d(vectors))
        if vectors.shape[1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {vectors.shape[1]}")
        n = vectors.shape[0]
        if n == 0:
            return np.empty((0,), dtype=np.int64)
        if self._refine is not None:
            self._refine.append(vectors)
        if not self._trained:
            start = len(self._staged)
            self._staged.extend(vectors)
            if len(self._staged) >= self.pq_train_threshold:
                self._train_and_flush()
            return np.arange(start, start + n, dtype=np.int64)
        start = self._lib.hnsw_add(self._handle, _fptr(vectors), n)
        return np.arange(start, start + n, dtype=np.int64)

    def _train_and_flush(self) -> None:
        """Train the PQ codebooks on the staged rows (up to 65536 used as
        the k-means sample), then build the graph from them in staging
        order — positions are preserved 1:1."""
        staged = np.ascontiguousarray(np.stack(self._staged), dtype=np.float32)
        sample = staged[:65536]
        rc = self._lib.hnsw_train_pq(
            self._handle, _fptr(sample), sample.shape[0]
        )
        if rc != 0:
            raise RuntimeError("hnsw_train_pq failed")
        self._lib.hnsw_add(self._handle, _fptr(staged), staged.shape[0])
        if self._staged_deleted:
            dead = np.ascontiguousarray(
                sorted(self._staged_deleted), dtype=np.int64
            )
            self._lib.hnsw_mark_deleted(
                self._handle,
                dead.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                dead.size,
            )
        self._staged = []
        self._staged_deleted = set()

    def _search_staged(
        self, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact brute-force over the pre-training staging buffer (bounded
        by pq_train_threshold rows, so this is small by construction)."""
        nq = queries.shape[0]
        scores = np.full((nq, k), -np.inf, dtype=np.float32)
        ids = np.full((nq, k), -1, dtype=np.int64)
        if not self._staged:
            return scores, ids
        corpus = np.stack(self._staged)
        if self.metric == "l2":
            s = -(
                (queries**2).sum(1, keepdims=True)
                - 2.0 * queries @ corpus.T
                + (corpus**2).sum(1)[None, :]
            )
        else:
            s = queries @ corpus.T
        if self._staged_deleted:
            s[:, sorted(self._staged_deleted)] = -np.inf
        k_eff = min(k, corpus.shape[0])
        top = np.argpartition(-s, k_eff - 1, axis=1)[:, :k_eff]
        top_s = np.take_along_axis(s, top, axis=1)
        order = np.argsort(-top_s, axis=1, kind="stable")
        scores[:, :k_eff] = np.take_along_axis(top_s, order, axis=1)
        ids[:, :k_eff] = np.take_along_axis(top, order, axis=1)
        ids[np.isneginf(scores)] = -1
        return scores, ids

    def search(
        self, queries: np.ndarray, k: int, ef: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        queries = self._prep(np.atleast_2d(queries))
        if k <= 0:
            raise ValueError("k must be positive")
        if not self._trained:
            return self._search_staged(queries, k)
        nq = queries.shape[0]
        k_fetch = k if self._refine is None else min(
            max(4 * k, 32), max(int(self._lib.hnsw_size(self._handle)), k)
        )
        scores = np.empty((nq, k_fetch), dtype=np.float32)
        ids = np.empty((nq, k_fetch), dtype=np.int64)
        self._lib.hnsw_search(
            self._handle,
            _fptr(queries),
            nq,
            k_fetch,
            int(ef or self.ef_search),
            _fptr(scores),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        scores = np.where(ids < 0, -np.inf, scores)
        if self._refine is None:
            return scores, ids
        # exact-rescore the widened candidate set against the SQ8 copy
        # (FAISS IndexRefine behavior), then re-top-k
        cand = self._refine.decode(ids)  # (nq, k_fetch, dim)
        if self.metric == "l2":
            d = cand - queries[:, None, :]
            exact = -np.einsum("qkd,qkd->qk", d, d)
        else:
            exact = np.einsum("qd,qkd->qk", queries, cand)
        exact = np.where(ids < 0, -np.inf, exact).astype(np.float32)
        order = np.argsort(-exact, axis=1, kind="stable")[:, :k]
        out_s = np.take_along_axis(exact, order, axis=1)
        out_i = np.take_along_axis(ids, order, axis=1)
        out_i = np.where(np.isneginf(out_s), -1, out_i)
        return out_s, out_i

    def mark_deleted(self, positions: np.ndarray) -> None:
        positions = np.ascontiguousarray(positions, dtype=np.int64)
        if positions.size == 0:
            return
        if not self._trained:
            # validate like the C++ path does: a -1 search-miss sentinel
            # forwarded here would wrap in the staged delete mask and
            # silently tombstone the LAST staged doc; count only rows
            # actually newly deleted (n_active drives caller behavior)
            valid = positions[(positions >= 0) & (positions < len(self._staged))]
            newly = {int(p) for p in valid} - self._staged_deleted
            self._staged_deleted.update(newly)
            self.n_deleted += len(newly)
            return
        newly = self._lib.hnsw_mark_deleted(
            self._handle,
            positions.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            positions.size,
        )
        self.n_deleted += int(newly)

    def take(self, positions: np.ndarray) -> np.ndarray:
        positions = np.asarray(positions, dtype=np.int64)
        if positions.size and (
            (positions < 0).any() or (positions >= self.size).any()
        ):
            # catch the search API's -1 miss sentinel here, not as an
            # out-of-bounds read in C (garbage vectors / segfault)
            raise ValueError("take() positions must be valid row ids (>= 0)")
        if not self._trained:
            return np.stack([self._staged[int(p)] for p in positions])
        out = np.empty((len(positions), self.dim), dtype=np.float32)
        for i, p in enumerate(positions):
            self._lib.hnsw_get_vector(self._handle, int(p), _fptr(out[i]))
        return out

    @property
    def size(self) -> int:
        return int(self._lib.hnsw_size(self._handle)) + len(self._staged)

    @property
    def n_active(self) -> int:
        return self.size - self.n_deleted

    def stats(self) -> Dict[str, object]:
        if self.pq_m:
            storage = "pq+refine" if self.pq_refine else "pq"
            # per-vector codes + the shared codebooks
            vector_bytes = self.size * self.pq_m + self.pq_m * 256 * (
                self.dim // self.pq_m
            ) * 4
            if self.pq_refine:
                vector_bytes += self.size * (self.dim + 4)  # SQ8 sidecar
        elif self.quantize:
            storage, vector_bytes = "sq8", self.size * self.dim
        else:
            storage, vector_bytes = "f32", self.size * self.dim * 4
        return {
            "kind": "hnsw",
            "dim": self.dim,
            "metric": self.metric,
            "M": self.M,
            "ef_construction": self.ef_construction,
            "ef_search": self.ef_search,
            "size": self.size,
            "active": self.n_active,
            "deleted": self.n_deleted,
            "quantized": self.quantize,
            "storage": storage,
            "pq_m": self.pq_m,
            "pq_trained": self._trained,
            "staged": len(self._staged),
            "vector_bytes": vector_bytes,
            "backend": "native-c++",
        }

    # -- persistence ---------------------------------------------------------

    def save(self, path: str | Path) -> None:
        if not self._trained:
            # the snapshot format stores codebooks + codes; materialize
            # them now (or fail loudly rather than write an empty file —
            # hnsw_load cannot read a V3 snapshot with empty codebooks)
            if len(self._staged) >= 256:
                if len(self._staged) < self.pq_train_threshold:
                    import warnings

                    warnings.warn(
                        f"snapshotting trains PQ codebooks on only "
                        f"{len(self._staged)} staged rows (configured "
                        f"pq_train_threshold={self.pq_train_threshold}); "
                        f"codebooks are frozen into the snapshot — recall "
                        f"may be lower than a threshold-sized training set "
                        f"would give",
                        stacklevel=2,
                    )
                self._train_and_flush()
            else:
                raise IOError(
                    "cannot snapshot an untrained PQ index with fewer than "
                    "256 staged rows; add more documents first"
                )
        rc = self._lib.hnsw_save(self._handle, str(path).encode())
        if rc != 0:
            raise IOError(f"hnsw_save failed for {path}")
        if self._refine is not None:
            np.savez(
                str(path) + ".refine.npz",
                codes=self._refine.codes[: self._refine.n],
                scales=self._refine.scales[: self._refine.n],
            )

    @classmethod
    def load(
        cls,
        path: str | Path,
        metric: str = "cosine",
        ef_search: int = 64,
    ) -> "HNSWIndex":
        lib = _bind()
        handle = lib.hnsw_load(str(path).encode())
        if not handle:
            raise IOError(f"hnsw_load failed for {path}")
        # dim/M recovered via a probe search call is overkill; stash them in
        # the python wrapper by reading the snapshot header
        import struct

        with open(path, "rb") as f:
            magic = f.read(8)
            dim, M, efc, metric_code, _ = struct.unpack("<5i", f.read(20))
        index = cls.__new__(cls)
        index._lib = lib
        index._handle = handle
        index.dim = dim
        index.M = M
        index.ef_construction = efc
        index.metric = metric if metric_code == 0 else "l2"
        index.ef_search = ef_search
        quant = int(lib.hnsw_is_quantized(handle))  # 0=f32, 1=sq8, 2=pq
        index.quantize = quant == 1
        index.pq_m = int(lib.hnsw_pq_m(handle))
        index.pq_train_threshold = 4096
        index._staged = []
        index._staged_deleted = set()
        # the snapshot preserves per-node deleted flags; count them so
        # n_active / compaction-threshold logic stays correct after load
        index.n_deleted = int(lib.hnsw_count_deleted(handle))
        sidecar = Path(str(path) + ".refine.npz")
        index.pq_refine = sidecar.exists()
        index._refine = None
        if index.pq_refine:
            with np.load(sidecar) as z:
                store = _RefineStore(dim)
                store.codes = np.ascontiguousarray(z["codes"])
                store.scales = np.ascontiguousarray(z["scales"])
                store.n = store.codes.shape[0]
            index._refine = store
        return index
