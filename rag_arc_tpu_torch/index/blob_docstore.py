"""Disk-backed document store for 10M-doc corpora.

The port's own copy of ``rag_arc_tpu/index/blob_docstore.py``, its behaviour
unchanged, so the port imports nothing of the JAX package.

The in-RAM ``Docstore`` (``index/docstore.py``) holds every ``Document``
in a python dict — fine to ~1M docs, but the north-star corpus is 10M×768
and a dict of 10M Document objects costs multiple GB of host RAM plus
unbounded GC pressure. This store keeps **content on disk** and bounds
host memory to ~28 bytes/doc of numpy bookkeeping:

- ``blob.jsonl``: append-only record file, one JSON object per document
  (``{"id", "content", "metadata"}``). Writes are buffered appends; reads
  go through a re-openable mmap, so resolving a query's top-k documents
  touches k pages, not the whole file.
- position index: flat numpy arrays ``off``/``length`` indexed by the
  device index's integer position — the only thing device code ever emits.
- id index: (hash, position) pairs — a sorted uint64 array merged from a
  small pending dict, looked up by ``searchsorted``. Collisions (~1e-6 at
  10M ids) are disambiguated by reading the record and comparing ids.

Same interface as ``Docstore`` so ``TPUVectorStore`` takes either
(``docstore_path=`` selects this one). Deletes tombstone; ``reassign``
rewrites the position arrays after index compaction; ``save``/``load``
snapshot the blob + arrays and are wired into ``index/persistence.py``.

Reference parity note: the reference pickles its whole docstore dict
(``VectorStore_Faiss.py:432-482``) and loads it all back into RAM; this
is the scale-path replacement the north star requires (SURVEY §6).
"""

from __future__ import annotations

import hashlib
import json
import mmap
import os
import shutil
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from rag_arc_tpu_torch.utils.data_model import Document
from rag_arc_tpu_torch.utils.tracing import stage

_MERGE_THRESHOLD = 65536  # pending id->pos entries before a sorted merge


def _id_hash(doc_id: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(doc_id.encode("utf-8"), digest_size=8).digest(), "big"
    )


class BlobDocstore:
    def __init__(self, path: str | Path, cache_docs: int = 65536):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self._blob_path = self.path / "blob.jsonl"
        self._blob = open(self._blob_path, "ab")
        self._mmap: Optional[mmap.mmap] = None
        self._mmap_size = 0
        # parsed-Document LRU for the serving hot path: resolving a
        # request's top-k pays a json.loads + Document build per record
        # (~35 µs each — the single biggest host cost per /batch request
        # measured on the 1-CPU box). Keyed by (pos, blob offset): a
        # rewrite appends a NEW offset so stale entries can never hit,
        # and deletes tombstone _len before the cache is consulted.
        # Sharing instances matches the RAM Docstore's contract (callers
        # that stamp scores copy first — see rerank/cross_encoder.py).
        self._doc_cache: "OrderedDict[Tuple[int, int], Document]" = OrderedDict()
        self._doc_cache_cap = int(cache_docs)
        self._doc_cache_lock = threading.Lock()
        # position -> record location; -1 length = empty/deleted slot
        self._off = np.zeros(1024, dtype=np.int64)
        self._len = np.full(1024, -1, dtype=np.int64)
        self._count = 0
        # id-hash -> positions: sorted core + small pending overlay. The
        # overlay maps hash -> LIST (newest first): two distinct ids that
        # collide within one merge window must both stay findable — a
        # single slot silently orphaned the earlier id's record
        self._h_sorted = np.empty(0, dtype=np.uint64)
        self._p_sorted = np.empty(0, dtype=np.int64)
        self._pending: Dict[int, List[int]] = {}
        if (self.path / "index.npz").exists():
            self._restore_index()

    # -- internal ----------------------------------------------------------

    def _ensure_capacity(self, pos_max: int) -> None:
        cap = len(self._off)
        if pos_max < cap:
            return
        while cap <= pos_max:
            cap *= 2
        off = np.zeros(cap, dtype=np.int64)
        length = np.full(cap, -1, dtype=np.int64)
        off[: len(self._off)] = self._off
        length[: len(self._len)] = self._len
        self._off, self._len = off, length

    def _merge_pending(self, force: bool = False) -> None:
        n = sum(len(v) for v in self._pending.values())
        if not n or (not force and n < _MERGE_THRESHOLD):
            return
        h = np.empty(n, dtype=np.uint64)
        p = np.empty(n, dtype=np.int64)
        i = 0
        for hh, plist in self._pending.items():
            # chronological (oldest first): the stable sort then keeps the
            # newest entry last, and lookups walk equal-hash runs newest-first
            for pp in reversed(plist):
                h[i] = hh
                p[i] = pp
                i += 1
        h_all = np.concatenate([self._h_sorted, h])
        p_all = np.concatenate([self._p_sorted, p])
        order = np.argsort(h_all, kind="stable")
        self._h_sorted = h_all[order]
        self._p_sorted = p_all[order]
        self._pending.clear()

    def _positions_for_hash(self, h: int) -> Iterator[int]:
        """All candidate positions for an id hash (collisions + rewrites)."""
        for pos in self._pending.get(h, ()):
            yield pos
        lo = int(np.searchsorted(self._h_sorted, np.uint64(h), side="left"))
        hi = int(np.searchsorted(self._h_sorted, np.uint64(h), side="right"))
        # later duplicates (id re-adds) shadow earlier ones: iterate newest
        # first — within equal hashes stable sort preserves append order
        for i in range(hi - 1, lo - 1, -1):
            yield int(self._p_sorted[i])

    def _read_record(self, pos: int) -> Optional[dict]:
        if pos < 0 or pos >= len(self._len) or self._len[pos] < 0:
            return None
        off, length = int(self._off[pos]), int(self._len[pos])
        if self._mmap is None or off + length > self._mmap_size:
            self._blob.flush()
            size = os.path.getsize(self._blob_path)
            if size == 0 or off + length > size:
                return None
            if self._mmap is not None:
                self._mmap.close()
            with open(self._blob_path, "rb") as f:
                self._mmap = mmap.mmap(f.fileno(), size, access=mmap.ACCESS_READ)
            self._mmap_size = size
        return json.loads(self._mmap[off : off + length])

    # -- Docstore interface --------------------------------------------------

    def __len__(self) -> int:
        return self._count

    def __contains__(self, doc_id: str) -> bool:
        return self.position_of(doc_id) is not None

    def add(self, documents: Sequence[Document], positions: Sequence[int]) -> List[str]:
        with stage("docstore.add", rows=len(documents)):
            return self._add(documents, positions)

    def _add(self, documents: Sequence[Document], positions: Sequence[int]) -> List[str]:
        if len(documents) != len(positions):
            raise ValueError("documents and positions length mismatch")
        if not documents:
            return []
        # pass 1: serialize EVERY record before touching any state — a
        # json.dumps failure mid-batch (e.g. a numpy scalar in metadata)
        # must not leave earlier old-slots tombstoned and offsets pointing
        # at bytes that were never written
        recs: List[tuple] = []
        for doc, pos in zip(documents, positions):
            doc_id = doc.ensure_id()
            rec = json.dumps(
                {"id": doc_id, "content": doc.content, "metadata": doc.metadata},
                ensure_ascii=False,
            ).encode("utf-8") + b"\n"
            recs.append((doc_id, int(pos), rec))
        self._ensure_capacity(max(positions))
        self._blob.flush()
        offset = self._blob.tell()
        ids: List[str] = []
        chunks: List[bytes] = []
        batch_pos: Dict[str, int] = {}  # ids repeated within one batch
        for doc_id, pos, rec in recs:
            old = batch_pos.get(doc_id)
            if old is None:
                old = self.position_of(doc_id)
            batch_pos[doc_id] = pos
            if old is not None and old != pos:
                self._len[old] = -1
                self._count -= 1
            elif old == pos:
                self._count -= 1  # same-slot rewrite, re-counted below
            self._off[pos] = offset
            self._len[pos] = len(rec) - 1  # exclude newline
            offset += len(rec)
            chunks.append(rec)
            self._pending.setdefault(_id_hash(doc_id), []).insert(0, pos)
            self._count += 1
            ids.append(doc_id)
        self._blob.write(b"".join(chunks))
        self._blob.flush()
        self._merge_pending()
        return ids

    def get_by_ids(self, ids: Iterable[str]) -> List[Document]:
        out = []
        for doc_id in ids:
            pos = self.position_of(doc_id)
            if pos is not None:
                doc = self.get_by_position(pos)
                if doc is not None:
                    out.append(doc)
        return out

    def get_by_position(self, pos: int) -> Optional[Document]:
        pos = int(pos)
        if (
            self._doc_cache_cap > 0
            and 0 <= pos < len(self._len)
            and self._len[pos] >= 0
        ):
            key = (pos, int(self._off[pos]))
            with self._doc_cache_lock:
                doc = self._doc_cache.get(key)
                if doc is not None:
                    self._doc_cache.move_to_end(key)
                    return doc
            rec = self._read_record(pos)
            if rec is None:
                return None
            doc = Document(
                content=rec["content"], metadata=rec["metadata"], id=rec["id"]
            )
            with self._doc_cache_lock:
                self._doc_cache[key] = doc
                while len(self._doc_cache) > self._doc_cache_cap:
                    self._doc_cache.popitem(last=False)
            return doc
        rec = self._read_record(pos)
        if rec is None:
            return None
        return Document(content=rec["content"], metadata=rec["metadata"], id=rec["id"])

    def position_of(self, doc_id: str) -> Optional[int]:
        h = _id_hash(doc_id)
        for pos in self._positions_for_hash(h):
            rec = self._read_record(pos)
            if rec is not None and rec["id"] == doc_id:
                return pos
        return None

    def delete(self, ids: Iterable[str]) -> List[int]:
        freed = []
        for doc_id in ids:
            pos = self.position_of(doc_id)
            if pos is None:
                continue
            self._len[pos] = -1
            self._count -= 1
            freed.append(pos)
        return freed

    def reassign(self, old_to_new: Dict[int, int]) -> None:
        """Apply a position remapping after index compaction."""
        off = np.zeros_like(self._off)
        length = np.full_like(self._len, -1)
        live = np.nonzero(self._len >= 0)[0]
        for old in live:
            new = old_to_new.get(int(old), int(old))
            off[new] = self._off[old]
            length[new] = self._len[old]
        self._off, self._len = off, length
        self._merge_pending(force=True)
        remap = np.fromiter(
            (old_to_new.get(int(p), int(p)) for p in self._p_sorted),
            dtype=np.int64,
            count=len(self._p_sorted),
        )
        self._p_sorted = remap

    def all_ids(self) -> List[str]:
        """Scans live records on disk — O(corpus); prefer positions."""
        live = np.nonzero(self._len >= 0)[0]
        out = []
        for pos in live:
            rec = self._read_record(int(pos))
            if rec is not None:
                out.append(rec["id"])
        return out

    def items(self) -> Iterator[Tuple[str, Document]]:
        """Streaming iterator (never materializes the corpus in RAM)."""
        live = np.nonzero(self._len >= 0)[0]
        for pos in live:
            doc = self.get_by_position(int(pos))
            if doc is not None:
                yield doc.id, doc

    def live_positions(self) -> np.ndarray:
        return np.nonzero(self._len >= 0)[0]

    # -- persistence ----------------------------------------------------------

    def save(self, path: str | Path) -> Path:
        """Snapshot blob + indexes to ``path`` (no-op copy if same dir)."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        self._blob.flush()
        self._merge_pending(force=True)
        if path.resolve() != self.path.resolve():
            shutil.copyfile(self._blob_path, path / "blob.jsonl")
        np.savez(
            path / "index.npz",
            off=self._off,
            len=self._len,
            h=self._h_sorted,
            p=self._p_sorted,
            count=np.int64(self._count),
        )
        return path

    def _restore_index(self) -> None:
        data = np.load(self.path / "index.npz")
        self._off = data["off"]
        self._len = data["len"]
        self._h_sorted = data["h"]
        self._p_sorted = data["p"]
        self._count = int(data["count"])

    def close(self) -> None:
        if self._mmap is not None:
            self._mmap.close()
            self._mmap = None
        self._blob.close()
