"""Host-side document store.

A copy of ``rag_arc_tpu/index/docstore.py``: the module itself is
host-only, but importing it runs ``rag_arc_tpu/index/__init__.py``, which
imports the JAX index modules, and the port never imports JAX.

Replaces the reference's FAISS sidecar bookkeeping
(``VectorStore_Faiss.py:96-97``: ``docstore: dict[id→Document]`` +
``index_to_docstore_id: dict[int→id]``). Device code only ever produces
integer *positions* (row indices into the HBM index); this store resolves
positions → ids → Documents at the end of a query, and ids → positions for
deletes. Deletes tombstone (the device index masks the row); compaction is
the index's concern, which calls ``reassign`` afterwards.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

from rag_arc_tpu.utils.data_model import Document


class Docstore:
    def __init__(self) -> None:
        self._docs: Dict[str, Document] = {}
        self._id_to_pos: Dict[str, int] = {}
        self._pos_to_id: Dict[int, str] = {}

    def __len__(self) -> int:
        return len(self._docs)

    def __contains__(self, doc_id: str) -> bool:
        return doc_id in self._docs

    def add(self, documents: Sequence[Document], positions: Sequence[int]) -> List[str]:
        """Record documents at their index positions; returns their ids.

        Re-adding an existing id overwrites its document and remaps its
        position (the caller is responsible for tombstoning the old row).
        """
        if len(documents) != len(positions):
            raise ValueError("documents and positions length mismatch")
        ids = []
        for doc, pos in zip(documents, positions):
            doc_id = doc.ensure_id()
            old_pos = self._id_to_pos.get(doc_id)
            if old_pos is not None:
                self._pos_to_id.pop(old_pos, None)
            self._docs[doc_id] = doc
            self._id_to_pos[doc_id] = int(pos)
            self._pos_to_id[int(pos)] = doc_id
            ids.append(doc_id)
        return ids

    def get_by_ids(self, ids: Iterable[str]) -> List[Document]:
        return [self._docs[i] for i in ids if i in self._docs]

    def get_by_position(self, pos: int) -> Optional[Document]:
        doc_id = self._pos_to_id.get(int(pos))
        return self._docs.get(doc_id) if doc_id is not None else None

    def position_of(self, doc_id: str) -> Optional[int]:
        return self._id_to_pos.get(doc_id)

    def delete(self, ids: Iterable[str]) -> List[int]:
        """Remove documents; returns the index positions to tombstone."""
        freed = []
        for doc_id in ids:
            pos = self._id_to_pos.pop(doc_id, None)
            if pos is None:
                continue
            self._pos_to_id.pop(pos, None)
            self._docs.pop(doc_id, None)
            freed.append(pos)
        return freed

    def reassign(self, old_to_new: Dict[int, int]) -> None:
        """Apply a position remapping after index compaction."""
        new_pos_to_id: Dict[int, str] = {}
        for old, doc_id in self._pos_to_id.items():
            new = old_to_new.get(old, old)
            new_pos_to_id[new] = doc_id
            self._id_to_pos[doc_id] = new
        self._pos_to_id = new_pos_to_id

    def all_ids(self) -> List[str]:
        return list(self._docs)

    def items(self):
        return self._docs.items()
