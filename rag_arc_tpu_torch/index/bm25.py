"""Device-resident BM25 index (counterpart of ``rag_arc_tpu/index/bm25.py``).

The host builds the vocabulary, document frequencies and the term arrays
(see ``rag_arc_tpu_torch/ops/bm25.py``); the device answers batched
queries. Three scoring backends sit behind one interface:

- ``host``: term-major CSR postings in C++ (``native/bm25host.cpp``):
  term-at-a-time accumulation touches only ~df(t) entries per term, no
  ``qmax`` truncation, threads across the batch. ``auto`` resolves to it.
- ``device``: the dense doc-major scan; O(N·Dmax) work per query term,
  whatever the term's selectivity, and queries truncated to ``qmax``
  unique terms.
- ``hybrid``: the host scorer plus a head-dense / tail-sparse device
  program. Each query is routed by its Σ df: a selective query goes to
  the host scorer, a heavy one to the device, where head terms cost one
  matmul over all docs. Both are exact, so the choice is per query.

Device-bound queries queue at dispatch and flush as one merged program
at first fetch (the coalescer), since the hybrid program's cost is
nearly independent of B.

Mutation follows the JAX package: BM25's global statistics (idf, avgdl)
make incremental updates incorrect, so adds and deletes rebuild. A mesh
is not supported yet (ROADMAP Queue 1 [#15]).
"""

from __future__ import annotations

import ctypes
import os
import threading
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rag_arc_tpu_torch.ops.bm25 import (
    DOC_PAD,
    QUERY_PAD,
    bm25_hybrid_topk_flat,
    bm25_scores_kernel,
    bm25_tail_only_topk,
    bm25_topk,
    compute_doc_weights,
    compute_idf,
)
from rag_arc_tpu_torch.index.flat import pair_readback
from rag_arc_tpu_torch.utils.locks import RWLock

def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class PendingSearch:
    """Handle for an in-flight query batch. ``result()`` blocks until the
    (scores, positions) arrays are on the host. Device-backed batches are
    asynchronous until then, so a caller streaming batches overlaps the
    next batch's host encode with the current batch's device program."""

    __slots__ = ("_fetch", "_out", "_prime")

    def __init__(
        self,
        fetch: Callable[[], Tuple[np.ndarray, np.ndarray]],
        prime: Optional[Callable[[], None]] = None,
    ):
        self._fetch = fetch
        self._prime = prime
        self._out: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._out is None:
            self._out = self._fetch()
        return self._out

    def prime(self) -> None:
        """Force any lazy device launch NOW (without blocking on results):
        the coalescer merges queued queries into one program at first
        demand; a streaming driver primes every handle before its first
        ``result()`` so all launches register with the active
        ``TransferPool`` and the stream reads back in one flush."""
        if self._out is None and self._prime is not None:
            self._prime()


class DeviceBM25Index:
    """Immutable-once-built BM25 scoring structure on ``device``.

    ``backend``: ``auto`` (= ``host`` without a mesh), ``host``, ``device``
    or ``hybrid``. ``head_terms`` and ``host_budget`` shape the hybrid
    backend (``host_budget`` None routes by ``n_docs // 16``; 0 sends
    every query with an indexed term to the device). The head is f32: the
    JAX package's bf16 head option is not ported."""

    def __init__(
        self,
        k1: float = 1.5,
        b: float = 0.75,
        epsilon: float = 0.25,
        qmax: int = 32,
        mesh=None,
        backend: str = "auto",
        head_terms: int = 256,
        host_budget: Optional[int] = None,
        *,
        device: torch.device | str,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "DeviceBM25Index(mesh=) is not ported yet (ROADMAP Queue 1 [#15])"
            )
        if backend not in ("auto", "device", "host", "hybrid"):
            raise ValueError(
                f"backend must be auto/device/host/hybrid, got {backend!r}"
            )
        self.device = torch.device(device)
        self.k1, self.b, self.epsilon = k1, b, epsilon
        self.qmax = qmax
        self.head_terms = int(head_terms)
        # byte cap on the dense (H, N_pad) head matrix; _build_hybrid
        # halves H until it fits
        self.HEAD_BYTES_BUDGET = 6 << 30
        # host-RAM bound per build chunk: the head is written to the
        # device in row blocks of ~this many f32 bytes
        self.HEAD_CHUNK_BYTES = 1 << 28
        # max padded candidate window (slab slots per query) the tail-only
        # sort/segment-sum program accepts; wider batches take the dense
        # hybrid program
        self.TAIL_ONLY_WINDOW = 1 << 16
        # per-QUERY router boundary (Σ df of the query's indexed terms):
        # ≤ budget → host CSR scorer, > budget → the device program.
        # None scales with the corpus (max(2^15, n_docs // 16)), the JAX
        # package's default; re-tuning it for the card is open.
        self.host_budget = None if host_budget is None else int(host_budget)
        self._w_head = None       # (H, N_pad) device
        self._hvalid = None       # (N_pad,) device
        self._head_slot = None    # (V,) int32: term id -> head slot or -1
        self._tail_docs_dev = None  # postings doc ids (term-major) + zero pad
        self._tail_w_dev = None     # postings weights + zero pad
        self._tail_off = None     # (V+1,) int64
        self._df = None           # (V,) int64
        self.mesh = None
        self.n_shards = 1
        self.backend = backend
        self._use_host = backend in ("auto", "host", "hybrid")
        # device-query coalescer: queued device-bound entries flush as ONE
        # merged program at first fetch, in chunks of DEV_COALESCE_MAX
        self._dev_queue: List[dict] = []
        self._dev_qlock = threading.Lock()        # guards the list ONLY
        self._dev_flush_mutex = threading.Lock()  # serializes flushes
        self.DEV_COALESCE_MAX = 64
        self.n_docs = 0
        self.vocab: Dict[str, int] = {}
        self.avgdl = 0.0
        self.doc_terms: Optional[torch.Tensor] = None
        self.doc_weights: Optional[torch.Tensor] = None
        self.valid: Optional[torch.Tensor] = None
        self._host_handle = None
        self._host_lib = None
        # rebuilds free the C++ postings handle and swap the device
        # arrays; searches read them under the read lock
        self._rw = RWLock()

    def __del__(self):
        self._free_host()

    def _free_host(self) -> None:
        if getattr(self, "_host_handle", None):
            self._host_lib.bm25host_free(self._host_handle)
            self._host_handle = None

    def _put(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """A query-time operand on the device. On CUDA it is staged in
        pinned memory and copied without blocking, so the upload does not
        wait for the device programs already queued."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _build_host(
        self,
        row_offsets: np.ndarray,
        term_ids: np.ndarray,
        tfs: np.ndarray,
        doc_len: np.ndarray,
        df: np.ndarray,
    ) -> None:
        from rag_arc_tpu_torch.native.build import load_library

        lib = load_library("bm25host")
        lib.bm25host_build.restype = ctypes.c_void_p
        lib.bm25host_build.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ]
        lib.bm25host_free.argtypes = [ctypes.c_void_p]
        lib.bm25host_scores.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.bm25host_search.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
        ]
        self._free_host()
        row_offsets = np.ascontiguousarray(row_offsets, dtype=np.int64)
        term_ids = np.ascontiguousarray(term_ids, dtype=np.int32)
        tfs = np.ascontiguousarray(tfs, dtype=np.float32)
        doc_len = np.ascontiguousarray(doc_len, dtype=np.int64)
        df = np.ascontiguousarray(df, dtype=np.int64)
        self._host_lib = lib
        self._host_handle = lib.bm25host_build(
            row_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            term_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            tfs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            doc_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            df.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self.n_docs,
            # id-space size, NOT len(vocab): build_from_csr accepts partial
            # vocab dicts; a too-small size is an out-of-bounds write in
            # the C++ postings build
            len(df),
            self.k1,
            self.b,
            self.epsilon,
        )

    def _build_hybrid(
        self,
        row_offsets: np.ndarray,
        term_ids: np.ndarray,
        tfs: np.ndarray,
        doc_len: np.ndarray,
        df: np.ndarray,
    ) -> None:
        """Head-dense / tail-sparse structures from the CSR arrays."""
        # size the id space from df, not len(vocab): build_from_csr accepts
        # sparse/partial vocab dicts whose max id exceeds the entry count
        n, v = self.n_docs, len(df)
        idf = compute_idf(df.astype(np.float64), n, self.epsilon)
        counts = np.diff(row_offsets)
        doc_of = np.repeat(np.arange(n, dtype=np.int64), counts)
        norm = self.k1 * (
            1.0 - self.b + self.b * doc_len[doc_of].astype(np.float64)
            / max(self.avgdl, 1e-9)
        )
        w = (
            idf[term_ids] * tfs * (self.k1 + 1.0) / (tfs + norm)
        ).astype(np.float32)

        # head = highest-df terms worth densifying (df >= n/256 floor)
        df_min = max(4, n // 256)
        order = np.argsort(-df, kind="stable")
        head = order[: self.head_terms]
        head = head[df[head] >= df_min]
        h = len(head)
        # 1024-multiple pad: the top-k's 512/256-column groups divide it;
        # pad columns are hvalid=False -> -inf, never selected
        n_pad = _round_up(max(n, 1024), 1024)
        # cap the dense head by BYTES: shrinking H moves the overflow
        # terms to the tail postings (slower for those terms, still exact)
        while h > 1 and h * n_pad * 4 > self.HEAD_BYTES_BUDGET:
            h //= 2
        if h < len(head):
            warnings.warn(
                f"hybrid head shrunk {len(head)} -> {h} terms to fit the "
                f"{self.HEAD_BYTES_BUDGET >> 30} GiB head budget at "
                f"{n} docs (f32); "
                "overflow terms score via tail postings"
            )
            head = head[:h]
        head_slot = np.full(v, -1, dtype=np.int32)
        head_slot[head] = np.arange(h, dtype=np.int32)
        is_head = head_slot[term_ids] >= 0
        slots = head_slot[term_ids[is_head]]
        docs_h = doc_of[is_head]
        vals_h = w[is_head]
        hvalid = np.zeros(n_pad, dtype=bool)
        hvalid[:n] = True

        # the (H, N_pad) head goes to the device in row chunks, so the
        # host never holds it whole
        self._w_head = None  # free the previous corpus's head first
        w_head_dev = torch.zeros((max(h, 1), n_pad), dtype=torch.float32, device=self.device)
        chunk_rows = max(1, int(self.HEAD_CHUNK_BYTES // (n_pad * 4)))
        by_slot = np.argsort(slots, kind="stable")
        slots_s, docs_s, vals_s = slots[by_slot], docs_h[by_slot], vals_h[by_slot]
        for s0 in range(0, h, chunk_rows):
            e0 = min(s0 + chunk_rows, h)
            lo, hi_ = np.searchsorted(slots_s, [s0, e0])
            arr = np.zeros((e0 - s0, n_pad), dtype=np.float32)
            arr[slots_s[lo:hi_] - s0, docs_s[lo:hi_]] = vals_s[lo:hi_]
            w_head_dev[s0:e0] = self._put(arr)

        # tail postings, term-major, resident on the device: query time
        # ships only (start, len, count) per tail term. Head postings never
        # ride the tail gather (the matmul owns them).
        tail_mask = head_slot[term_ids] < 0
        t_ids = term_ids[tail_mask]
        sort_idx = np.argsort(t_ids, kind="stable")
        tail_docs = doc_of[tail_mask][sort_idx].astype(np.int32)
        tail_w = w[tail_mask][sort_idx]
        off = np.zeros(v + 1, dtype=np.int64)
        np.cumsum(np.bincount(t_ids, minlength=v), out=off[1:])
        if off[-1] >= (1 << 31):
            # start offsets pack into the int32 device operand
            raise ValueError(
                f"hybrid tail postings ({int(off[-1])}) exceed the int32 "
                "offset space of the packed device operands; use backend='host'"
            )
        self._tail_off = off
        self._df = df.astype(np.int64)
        self._head_slot = head_slot
        self._w_head = w_head_dev
        self._hvalid = self._put(hvalid)
        # slab width: posting lists split into segments of at most this
        # width at query time
        self._max_tail_df = int(max(64, n // 1024))
        # slab WIDTH BUCKETS: the scatter-add costs per slot, padding
        # included, so terms go to the smallest bucket that fits and long
        # lists split into max-width slabs
        self._tail_widths = tuple(
            sorted({w for w in (128, 1024) if w < self._max_tail_df}
                   | {self._max_tail_df})
        )
        # device copies carry a max_df zero pad so no slab window runs off
        # the end of the postings
        pad = self._max_tail_df
        self._tail_docs_dev = self._put(np.concatenate([tail_docs, np.zeros(pad, np.int32)]))
        self._tail_w_dev = self._put(np.concatenate([tail_w, np.zeros(pad, np.float32)]))

    def device_bytes(self) -> Dict[str, int]:
        """Bytes the hybrid or doc-major arrays hold on the device."""
        out = {}
        for name in ("_w_head", "_hvalid", "_tail_docs_dev", "_tail_w_dev",
                     "doc_terms", "doc_weights", "valid"):
            t = getattr(self, name, None)
            if t is not None:
                out[name.strip("_")] = t.numel() * t.element_size()
        return out

    def _count_terms(
        self, tokenized_queries: Sequence[Sequence[str]]
    ) -> List[Dict[int, int]]:
        """Per-query indexed-term-id → count maps: the one tokenize-count
        pass shared by the router, both encoders and the hybrid path."""
        out: List[Dict[int, int]] = []
        vocab_get = self.vocab.get
        for toks in tokenized_queries:
            counts: Dict[int, int] = {}
            for tok in toks:
                tid = vocab_get(tok)
                if tid is not None:
                    counts[tid] = counts.get(tid, 0) + 1
            out.append(counts)
        return out

    def _estimated_entries(self, counts: Sequence[Dict[int, int]]) -> int:
        """Σ df over the batch's indexed query terms: the host scorer's
        work, and the router's signal between host and device."""
        return int(sum(self._df[tid] for c in counts for tid in c))

    def _enqueue_device(
        self, tokenized_queries: Sequence[Sequence[str]], k: int
    ) -> PendingSearch:
        """Queue device-bound queries for a coalesced launch.

        The returned handle's ``result()`` flushes the queue (everything
        enqueued so far merges into one program, chunked at
        ``DEV_COALESCE_MAX`` queries) and slices out this entry's rows.
        Scores equal a solo dispatch's: the program scores each query
        independently."""
        entry: dict = {
            "tokens": [list(t) for t in tokenized_queries],
            "k": int(k),
            "pending": None,
            "lo": 0,
        }
        with self._dev_qlock:
            self._dev_queue.append(entry)

        def launch() -> None:
            while entry["pending"] is None:
                # the mutex serializes flushes and makes a fetch BLOCK
                # while another thread's flush (holding our entry) runs
                with self._dev_flush_mutex:
                    if entry["pending"] is None:
                        self._flush_device()

        def fetch() -> Tuple[np.ndarray, np.ndarray]:
            launch()
            s, p = entry["pending"].result()
            lo, b = entry["lo"], len(entry["tokens"])
            s, p = s[lo : lo + b], p[lo : lo + b]
            if s.shape[1] > entry["k"]:
                # the merged batch ran at the queue's max k; every row's
                # prefix is its own exact top-k (the zero-fill included)
                s, p = s[:, : entry["k"]], p[:, : entry["k"]]
            return s, p

        return PendingSearch(fetch, prime=launch)

    def _flush_device(self) -> None:
        """Dispatch every queued device-bound entry (caller holds
        ``_dev_flush_mutex``). ``_dev_qlock`` guards only the list swap:
        holding it across ``_rw.read()`` would invert the lock order of
        ``search_dispatch`` (read → qlock) and deadlock under a waiting
        writer (the RW lock is writer-preferring)."""
        with self._dev_qlock:
            queue, self._dev_queue = self._dev_queue, []
        if not queue:
            return

        def dispatch(chunk: List[dict]) -> None:
            toks = [t for e in chunk for t in e["tokens"]]
            k_max = max(e["k"] for e in chunk)
            # term counts recompute at flush time so a rebuild that landed
            # between enqueue and flush cannot feed stale term ids into
            # the new postings layout
            with self._rw.read():
                pending = self._hybrid_dispatch(toks, k_max, self._count_terms(toks))
            lo = 0
            for e in chunk:
                e["lo"] = lo
                e["pending"] = pending
                lo += len(e["tokens"])

        chunk: List[dict] = []
        n = 0
        for e in queue:
            if chunk and n + len(e["tokens"]) > self.DEV_COALESCE_MAX:
                dispatch(chunk)
                chunk, n = [], 0
            chunk.append(e)
            n += len(e["tokens"])
        if chunk:
            dispatch(chunk)

    def _hybrid_operands(
        self, term_counts: Sequence[Dict[int, int]]
    ) -> Tuple[bool, np.ndarray, tuple, tuple]:
        """Host encoding of one hybrid batch: (tail_only, packed, widths,
        slot counts). Each query's tail terms land in the smallest width
        bucket that fits their df (long lists split into max-width slabs).
        Head-carrying batches use the batch-flat layout
        [q_head (b·h) | per bucket: starts(s) lens(s) counts(s) qids(s)]
        (slabs pooled across queries); head-free batches whose candidate
        window fits ``TAIL_ONLY_WINDOW`` use per-query slab windows
        (b, [starts | lens | counts] per bucket) for the sort/segment
        program, which needs no (B, N) score array."""
        b = len(term_counts)
        h = self._w_head.shape[0]
        max_df = self._max_tail_df
        widths = self._tail_widths
        rows: List[Dict[int, List[Tuple[int, int, int]]]] = []
        head_rows: List[Dict[int, int]] = []
        t_max = {w: 0 for w in widths}
        for counts in term_counts:
            row: Dict[int, List[Tuple[int, int, int]]] = {w: [] for w in widths}
            hrow: Dict[int, int] = {}
            for tid, c in counts.items():
                slot = self._head_slot[tid]
                if slot >= 0:
                    hrow[int(slot)] = hrow.get(int(slot), 0) + c
                else:
                    start = int(self._tail_off[tid])
                    remaining = int(self._tail_off[tid + 1]) - start
                    while remaining > max_df:
                        row[max_df].append((start, max_df, c))
                        start += max_df
                        remaining -= max_df
                    if remaining > 0:
                        w = next(w for w in widths if w >= remaining)
                        row[w].append((start, remaining, c))
            rows.append(row)
            head_rows.append(hrow)
            for w in widths:
                t_max[w] = max(t_max[w], len(row[w]))

        # only buckets the batch uses are gathered
        used = tuple(w for w in widths if t_max[w] > 0) or (widths[0],)
        ts = tuple(max(1, t_max[w]) for w in used)
        cand_window = sum(w * t for w, t in zip(used, ts))
        if not any(head_rows) and cand_window <= self.TAIL_ONLY_WINDOW:
            packed = np.zeros((b, 3 * sum(ts)), dtype=np.int32)
            for i, row in enumerate(rows):
                o = 0
                for w, t in zip(used, ts):
                    for j, (s, ln, c) in enumerate(row[w]):
                        packed[i, o + j] = s
                        packed[i, o + t + j] = ln
                        packed[i, o + 2 * t + j] = c
                    o += 3 * t
            return True, packed, used, ts
        flat: Dict[int, List[Tuple[int, int, int, int]]] = {w: [] for w in used}
        for i, row in enumerate(rows):
            for w in used:
                for s, ln, c in row[w]:
                    flat[w].append((s, ln, c, i))
        ss = tuple(max(1, len(flat[w])) for w in used)
        packed = np.zeros(b * h + 4 * sum(ss), dtype=np.int32)
        qh = np.zeros((b, h), dtype=np.int32)
        for i, hrow in enumerate(head_rows):
            for slot, c in hrow.items():
                qh[i, slot] = c
        packed[: b * h] = qh.reshape(-1)
        o = b * h
        for w, s_n in zip(used, ss):
            for j, (s, ln, c, qi) in enumerate(flat[w]):
                packed[o + j] = s
                packed[o + s_n + j] = ln
                packed[o + 2 * s_n + j] = c
                packed[o + 3 * s_n + j] = qi
            o += 4 * s_n
        return False, packed, used, ss

    def _hybrid_dispatch(
        self,
        tokenized_queries: Sequence[Sequence[str]],
        k: int,
        term_counts: Optional[Sequence[Dict[int, int]]] = None,
    ) -> PendingSearch:
        """Host-encode and launch one hybrid batch; does NOT block on the
        device. The operands travel as ONE packed int32 tensor, and the
        (scores, positions) pair rides the active ``TransferPool`` when
        there is one."""
        b = len(tokenized_queries)
        if term_counts is None:
            term_counts = self._count_terms(tokenized_queries)
        tail_only, packed, widths, slots = self._hybrid_operands(term_counts)
        k_eff = min(k, self.n_docs)
        if tail_only:
            sk, ik = bm25_tail_only_topk(
                self._tail_docs_dev, self._tail_w_dev, self._upload(packed),
                k_eff, widths, slots,
            )
        else:
            sk, ik = bm25_hybrid_topk_flat(
                self._w_head, self._hvalid, self._tail_docs_dev, self._tail_w_dev,
                self._upload(packed), k_eff, b, self._w_head.shape[0], widths, slots,
            )
        readback = pair_readback(sk, ik)

        def fetch() -> Tuple[np.ndarray, np.ndarray]:
            s, p = readback()
            out_s = np.full((b, k), -np.inf, dtype=np.float32)
            out_p = np.full((b, k), -1, dtype=np.int64)
            out_s[:, :k_eff] = s
            # -inf slots are empty whatever index the top-k left there
            out_p[:, :k_eff] = np.where(np.isneginf(s), -1, p)
            if tail_only:
                # rank_bm25 argsort semantics: unmatched docs score 0 and
                # rank above nothing. Tail term weights are strictly
                # positive (df < n/256 ⇒ idf > 0), so every candidate the
                # program returned outranks the zeros, and the remaining
                # slots fill with the smallest doc ids not already
                # returned, in rank order: the dense path's tie order.
                n_docs = self.n_docs
                for i in range(b):
                    got = set(int(x) for x in out_p[i][out_p[i] >= 0].tolist())
                    nxt = 0
                    for j in range(k_eff):
                        if out_p[i, j] >= 0:
                            continue
                        while nxt in got and nxt < n_docs:
                            nxt += 1
                        if nxt >= n_docs:
                            break
                        out_p[i, j] = nxt
                        out_s[i, j] = 0.0
                        nxt += 1
            return out_s, out_p

        return PendingSearch(fetch)

    def _hybrid_search(
        self, tokenized_queries: Sequence[Sequence[str]], k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        return self._hybrid_dispatch(tokenized_queries, k).result()

    # -- build ------------------------------------------------------------

    def build(self, tokenized_docs: Sequence[Sequence[str]]) -> None:
        with self._rw.write():
            self._build_unlocked(tokenized_docs)

    def _clear(self) -> None:
        self.doc_terms = self.doc_weights = self.valid = None
        self.avgdl = 0.0
        self._free_host()
        # drop the previous corpus's hybrid structures too (GBs at scale),
        # or stats() would keep reporting the old head terms
        self._w_head = self._hvalid = None
        self._tail_docs_dev = self._tail_w_dev = None
        self._tail_off = self._df = self._head_slot = None

    def _build_unlocked(self, tokenized_docs: Sequence[Sequence[str]]) -> None:
        n = len(tokenized_docs)
        self.n_docs = n
        self.vocab = {}
        if n == 0:
            self._clear()
            return
        doc_tfs: List[Dict[int, int]] = []
        doc_len = np.zeros(n, dtype=np.float64)
        for i, doc in enumerate(tokenized_docs):
            tf: Dict[int, int] = {}
            for tok in doc:
                tid = self.vocab.setdefault(tok, len(self.vocab))
                tf[tid] = tf.get(tid, 0) + 1
            doc_tfs.append(tf)
            doc_len[i] = len(doc)
        self.avgdl = float(doc_len.mean())
        v = len(self.vocab)
        df = np.zeros(v, dtype=np.float64)
        for tf in doc_tfs:
            for tid in tf:
                df[tid] += 1
        if self._use_host:
            nnz = sum(len(tf) for tf in doc_tfs)
            row_offsets = np.zeros(n + 1, dtype=np.int64)
            np.cumsum([len(tf) for tf in doc_tfs], out=row_offsets[1:])
            term_ids = np.fromiter(
                (t for tf in doc_tfs for t in tf), dtype=np.int32, count=nnz
            )
            tf_vals = np.fromiter(
                (c for tf in doc_tfs for c in tf.values()), dtype=np.float32, count=nnz
            )
            self._build_host(
                row_offsets, term_ids, tf_vals, doc_len.astype(np.int64), df.astype(np.int64),
            )
            if self.backend == "hybrid":
                self._build_hybrid(row_offsets, term_ids, tf_vals, doc_len, df)
            return
        idf = compute_idf(df, n, self.epsilon)  # (V,)
        dmax = _round_up(max(max((len(tf) for tf in doc_tfs), default=1), 8), 8)
        n_pad = _round_up(n, 8)
        terms = np.full((n_pad, dmax), DOC_PAD, dtype=np.int32)
        tfs = np.zeros((n_pad, dmax), dtype=np.float32)
        idf_slot = np.zeros((n_pad, dmax), dtype=np.float32)
        for i, tf in enumerate(doc_tfs):
            tids = np.fromiter(tf.keys(), dtype=np.int32, count=len(tf))
            terms[i, : len(tf)] = tids
            tfs[i, : len(tf)] = np.fromiter(tf.values(), dtype=np.float32, count=len(tf))
            idf_slot[i, : len(tf)] = idf[tids]
        self._put_doc_major(terms, tfs, idf_slot, doc_len, n)

    def _put_doc_major(self, terms, tfs, idf_slot, doc_len, n) -> None:
        n_pad = terms.shape[0]
        doc_len_pad = np.zeros(n_pad, dtype=np.float64)
        doc_len_pad[:n] = doc_len
        weights = compute_doc_weights(tfs, idf_slot, doc_len_pad, self.avgdl, self.k1, self.b)
        valid = np.zeros(n_pad, dtype=bool)
        valid[:n] = True
        self.doc_terms = self._put(terms)
        self.doc_weights = self._put(weights)
        self.valid = self._put(valid)

    def build_from_csr(
        self,
        row_offsets: np.ndarray,
        term_ids: np.ndarray,
        tfs: np.ndarray,
        doc_len: np.ndarray,
        vocab: Optional[Dict[str, int]] = None,
    ) -> None:
        """Build directly from CSR term-frequency arrays (host/hybrid
        backends only). ``term_ids`` must be unique within each row (one
        entry per distinct term, its count in ``tfs``). ``vocab`` maps
        token -> id for query encoding; defaults to ``{"w{i}": i}``."""
        with self._rw.write():
            self._build_from_csr_unlocked(row_offsets, term_ids, tfs, doc_len, vocab)

    def _build_from_csr_unlocked(self, row_offsets, term_ids, tfs, doc_len, vocab) -> None:
        if not self._use_host:
            raise ValueError("build_from_csr requires the host/hybrid backend")
        n = int(len(row_offsets)) - 1
        self.n_docs = n
        v = int(term_ids.max()) + 1 if len(term_ids) else 0
        self.vocab = vocab if vocab is not None else {f"w{i}": i for i in range(v)}
        if n == 0:
            self._build_unlocked([])
            return
        doc_len = np.asarray(doc_len, dtype=np.float64)
        self.avgdl = float(doc_len.mean())
        # size the id space by the LARGEST id anywhere, so a sparse vocab
        # never indexes past _df/_head_slot/_tail_off at query time
        if self.vocab:
            v = max(v, max(self.vocab.values()) + 1)
        v = max(v, len(self.vocab))
        # CSR rows hold one entry per distinct (doc, term): df is a bincount
        df = np.bincount(np.asarray(term_ids, dtype=np.int64), minlength=v).astype(np.int64)
        self._build_host(
            np.asarray(row_offsets, dtype=np.int64),
            np.asarray(term_ids, dtype=np.int32),
            np.asarray(tfs, dtype=np.float32),
            doc_len.astype(np.int64),
            df,
        )
        if self.backend == "hybrid":
            self._build_hybrid(
                np.asarray(row_offsets, dtype=np.int64),
                np.asarray(term_ids, dtype=np.int32),
                np.asarray(tfs, dtype=np.float32),
                doc_len,
                df.astype(np.float64),
            )

    def build_from_texts_native(self, contents: Sequence[str]) -> None:
        """Fast build: tokenization and term statistics in C++
        (``native/textproc.cpp``), byte-exact with ``text.lower().split()``
        for ASCII corpora. The caller checks ``str.isascii()`` and takes
        :meth:`build` otherwise."""
        with self._rw.write():
            self._build_from_texts_native_unlocked(contents)

    def _build_from_texts_native_unlocked(self, contents: Sequence[str]) -> None:
        from rag_arc_tpu_torch.native.build import load_library

        n = len(contents)
        self.n_docs = n
        if n == 0:
            self._build_unlocked([])
            return
        lib = load_library("textproc")
        lib.textproc_build.restype = ctypes.c_void_p
        lib.textproc_build.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ]
        for name in ("textproc_n_vocab", "textproc_dmax", "textproc_nnz",
                     "textproc_vocab_bytes"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        lib.textproc_free.argtypes = [ctypes.c_void_p]
        lib.textproc_export.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.textproc_vocab_export.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        blobs = [c.encode("ascii") for c in contents]
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        buffer = b"".join(blobs)
        handle = lib.textproc_build(
            buffer, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n
        )
        try:
            v = lib.textproc_n_vocab(handle)
            nnz = lib.textproc_nnz(handle)
            dmax = max(int(lib.textproc_dmax(handle)), 8)
            row_offsets = np.empty(n + 1, dtype=np.int64)
            term_ids = np.empty(max(nnz, 1), dtype=np.int32)
            tfs = np.empty(max(nnz, 1), dtype=np.float32)
            doc_len = np.empty(n, dtype=np.int64)
            df = np.empty(max(v, 1), dtype=np.int64)
            lib.textproc_export(
                handle,
                row_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                term_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                tfs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                doc_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                df.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            vocab_bytes = ctypes.create_string_buffer(int(lib.textproc_vocab_bytes(handle)))
            lib.textproc_vocab_export(handle, vocab_bytes)
        finally:
            lib.textproc_free(handle)
        terms_list = vocab_bytes.raw.decode("ascii").split("\n")[:-1]
        self.vocab = {t: i for i, t in enumerate(terms_list)}
        self.avgdl = float(doc_len.mean()) if n else 0.0
        if self._use_host:
            self._build_host(row_offsets, term_ids[:nnz], tfs[:nnz], doc_len, df)
            if self.backend == "hybrid":
                self._build_hybrid(
                    row_offsets, term_ids[:nnz], tfs[:nnz], doc_len.astype(np.float64), df,
                )
            return
        idf = compute_idf(df.astype(np.float64), n, self.epsilon)
        dmax = _round_up(dmax, 8)
        n_pad = _round_up(n, 8)
        terms = np.full((n_pad, dmax), DOC_PAD, dtype=np.int32)
        tf_arr = np.zeros((n_pad, dmax), dtype=np.float32)
        idf_slot = np.zeros((n_pad, dmax), dtype=np.float32)
        # vectorized CSR → padded scatter
        counts = np.diff(row_offsets)
        doc_of = np.repeat(np.arange(n), counts)
        col_of = np.arange(nnz, dtype=np.int64) - np.repeat(row_offsets[:-1], counts)
        terms[doc_of, col_of] = term_ids[:nnz]
        tf_arr[doc_of, col_of] = tfs[:nnz]
        idf_slot[doc_of, col_of] = idf[term_ids[:nnz]]
        self._put_doc_major(terms, tf_arr, idf_slot, doc_len, n)

    # -- query encoding ---------------------------------------------------

    def encode_queries(
        self, tokenized_queries: Sequence[Sequence[str]]
    ) -> Tuple[np.ndarray, np.ndarray]:
        b = len(tokenized_queries)
        qt = np.full((b, self.qmax), QUERY_PAD, dtype=np.int32)
        qc = np.zeros((b, self.qmax), dtype=np.float32)
        warned = False
        for i, counts in enumerate(self._count_terms(tokenized_queries)):
            if len(counts) > self.qmax and not warned:
                warned = True
                warnings.warn(
                    f"query has {len(counts)} unique indexed terms; only the "
                    f"{self.qmax} most frequent are scored (raise qmax for "
                    "long queries)"
                )
            # keep highest-count terms when over budget
            items = sorted(counts.items(), key=lambda kv: -kv[1])[: self.qmax]
            for j, (tid, c) in enumerate(items):
                qt[i, j] = tid
                qc[i, j] = c
        return qt, qc

    # -- search -----------------------------------------------------------

    def search(
        self, tokenized_queries: Sequence[Sequence[str]], k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (B, k), positions (B, k)); empty slots score -inf / -1."""
        return self.search_dispatch(tokenized_queries, k).result()

    def search_dispatch(
        self, tokenized_queries: Sequence[Sequence[str]], k: int
    ) -> PendingSearch:
        """Enqueue a query batch; returns a :class:`PendingSearch`.

        Device-backed batches return before the device program finishes;
        the host CSR backend computes eagerly (it IS host work)."""
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        b = len(tokenized_queries)
        # read lock: a concurrent rebuild frees the C++ postings handle and
        # swaps the device arrays
        with self._rw.read():
            if (self.doc_terms is None and self._host_handle is None) or b == 0:
                out = (
                    np.full((b, k), -np.inf, dtype=np.float32),
                    np.full((b, k), -1, dtype=np.int64),
                )
                return PendingSearch(lambda: out)
            if self._host_handle is not None:
                term_counts = self._count_terms(tokenized_queries)
                if self._w_head is None:
                    host_out = self._host_search(tokenized_queries, k, term_counts)
                    return PendingSearch(lambda: host_out)
                # PER-QUERY Σ df router: a query whose postings volume
                # exceeds the budget would drown the host scorer in
                # accumulations, the device pays one matmul for its head
                # terms instead. Mixed batches split: the device subset
                # is queued FIRST so host scoring overlaps its program.
                budget = (
                    self.host_budget if self.host_budget is not None
                    else max(1 << 15, self.n_docs // 16)
                )
                dev_idx = [
                    i for i, tc in enumerate(term_counts)
                    if self._estimated_entries([tc]) > budget
                ]
                if not dev_idx:
                    host_out = self._host_search(tokenized_queries, k, term_counts)
                    return PendingSearch(lambda: host_out)
                if len(dev_idx) == b:
                    return self._enqueue_device(tokenized_queries, k)
                dev_set = set(dev_idx)
                host_idx = [i for i in range(b) if i not in dev_set]
                pending_dev = self._enqueue_device([tokenized_queries[i] for i in dev_idx], k)
                host_out = self._host_search(
                    [tokenized_queries[i] for i in host_idx], k,
                    [term_counts[i] for i in host_idx],
                )

                def fetch_mixed() -> Tuple[np.ndarray, np.ndarray]:
                    ds, dp = pending_dev.result()
                    s = np.full((b, k), -np.inf, dtype=np.float32)
                    p = np.full((b, k), -1, dtype=np.int64)
                    s[dev_idx], p[dev_idx] = ds, dp
                    s[host_idx], p[host_idx] = host_out
                    return s, p

                return PendingSearch(fetch_mixed, prime=pending_dev.prime)
            qt, qc = self.encode_queries(tokenized_queries)
            # slots no query uses add nothing: scan only the used ones
            used = max(1, int((qt != QUERY_PAD).any(axis=0).sum()))
            n_pad = self.doc_terms.shape[0]
            k_eff = min(k, n_pad)
            scores, positions = bm25_topk(
                self.doc_terms, self.doc_weights, self.valid,
                self._upload(qt[:, :used]), self._upload(qc[:, :used]), k_eff,
            )
        readback = pair_readback(scores, positions)

        def fetch() -> Tuple[np.ndarray, np.ndarray]:
            s, p = readback()
            p = np.where(np.isneginf(s), -1, p)
            if k_eff < k:
                pad = k - k_eff
                s = np.pad(s, ((0, 0), (0, pad)), constant_values=-np.inf)
                p = np.pad(p, ((0, 0), (0, pad)), constant_values=-1)
            return s, p

        return PendingSearch(fetch)

    def _encode_flat(
        self, term_counts: Sequence[Dict[int, int]]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Variable-length query encoding for the host scorer: no ``qmax``
        truncation (the host path scores every indexed query term)."""
        terms: List[int] = []
        counts: List[float] = []
        offsets = np.zeros(len(term_counts) + 1, dtype=np.int64)
        for i, c in enumerate(term_counts):
            terms.extend(c.keys())
            counts.extend(float(v) for v in c.values())
            offsets[i + 1] = len(terms)
        return (
            np.asarray(terms, dtype=np.int32),
            np.asarray(counts, dtype=np.float32),
            offsets,
        )

    def _host_search(
        self,
        tokenized_queries: Sequence[Sequence[str]],
        k: int,
        term_counts: Optional[Sequence[Dict[int, int]]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        if term_counts is None:
            term_counts = self._count_terms(tokenized_queries)
        terms, counts, offsets = self._encode_flat(term_counts)
        b = len(tokenized_queries)
        out_scores = np.empty((b, k), dtype=np.float32)
        out_pos = np.empty((b, k), dtype=np.int64)
        if terms.size == 0:
            terms = np.zeros(1, dtype=np.int32)
            counts = np.zeros(1, dtype=np.float32)
        self._host_lib.bm25host_search(
            self._host_handle,
            terms.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            b,
            k,
            None,
            out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            min(os.cpu_count() or 1, 16),
        )
        return out_scores, out_pos

    def get_scores(self, tokenized_query: Sequence[str]) -> np.ndarray:
        """Full dense score vector for one query."""
        with self._rw.read():
            if self._host_handle is not None:
                terms, counts, _ = self._encode_flat(self._count_terms([tokenized_query]))
                out = np.zeros(self.n_docs, dtype=np.float32)
                if terms.size:
                    self._host_lib.bm25host_scores(
                        self._host_handle,
                        terms.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        terms.size,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    )
                return out
            if self.doc_terms is None:
                return np.zeros(0, dtype=np.float32)
            qt, qc = self.encode_queries([tokenized_query])
            scores = bm25_scores_kernel(
                self.doc_terms, self.doc_weights, self._put(qt), self._put(qc)
            )
            return scores[0, : self.n_docs].cpu().numpy()

    def stats(self) -> Dict[str, object]:
        return {
            "kind": "bm25",
            "backend": (
                "hybrid"
                if self._w_head is not None
                else ("host-csr" if self._host_handle is not None else "device")
            ),
            "head_terms": 0 if self._w_head is None else int(self._w_head.shape[0]),
            "num_docs": self.n_docs,
            "vocab_size": len(self.vocab),
            "avgdl": self.avgdl,
            "k1": self.k1,
            "b": self.b,
            "epsilon": self.epsilon,
            "qmax": self.qmax,
            "shards": self.n_shards,
            "dmax": 0 if self.doc_terms is None else int(self.doc_terms.shape[1]),
        }

