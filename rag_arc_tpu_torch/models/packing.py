"""Host-side sequence packing for the encoder serving path.

The port's own copy of ``rag_arc_tpu/models/packing.py``, its behaviour unchanged, so
the port imports nothing of the JAX package.

TPU-first replacement for the reference's per-batch HF embedding loop
(``core/file_management/embeddings/huggingface.py:105-134``), which pads
every text to the batch max and has no answer for short-query traffic.

Short documents are packed several-to-a-row so the device sees MXU-sized
(row_len) attention shapes regardless of document length — the measured
alternative (padding each short doc to its own row) collapses encoder MFU
from ~52% to ~34% because L=16 attention runs 16×16 matmuls
(tools/encoder_probe2.py). See ``PackedTextEncoder`` for the device side.

First-fit-decreasing by token count: near-optimal occupancy for the
short-query distributions this serves, O(n·R) worst case with a bounded
open-row window to keep host cost linear in practice.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

PAD_ID = 0


def pack_token_lists(
    token_lists: Sequence[List[int]],
    row_len: int = 128,
    max_segments: int = 8,
    pad_id: int = PAD_ID,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[Tuple[int, int]]]:
    """Pack token lists into rows.

    Returns ``(ids (R, row_len) int32, pos_ids (R, row_len) int32,
    seg_ids (R, row_len) int32 with -1 padding, mapping)`` where
    ``mapping[i] = (row, slot)`` locates document ``i``'s pooled
    embedding in the ``(R, max_segments, dim)`` model output.
    Documents longer than ``row_len`` are truncated (callers should
    route genuinely long docs through the unpacked bucket path).
    """
    n = len(token_lists)
    order = sorted(range(n), key=lambda i: -len(token_lists[i]))
    # open rows: (free_tokens, nseg, row_index); bounded window so packing
    # stays ~linear — FFD rarely needs to look far back
    rows_docs: List[List[Tuple[int, List[int]]]] = []
    rows_free: List[int] = []
    open_rows: List[int] = []
    WINDOW = 64
    for i in order:
        toks = token_lists[i][:row_len]
        # empty lists consume a SEGMENT SLOT but zero tokens: marking a
        # pad token live would pool the PAD hidden state into a unit-norm
        # vector, while the unpacked path (all-False mask) yields exact
        # zero — the slot stays unmarked so segment pooling returns 0 too
        need = len(toks)
        placed = -1
        for r in open_rows:
            if rows_free[r] >= need and len(rows_docs[r]) < max_segments:
                placed = r
                break
        if placed < 0:
            placed = len(rows_docs)
            rows_docs.append([])
            rows_free.append(row_len)
            open_rows.append(placed)
            if len(open_rows) > WINDOW:
                open_rows.pop(0)
        rows_docs[placed].append((i, toks))
        rows_free[placed] -= need
        if rows_free[placed] == 0 or len(rows_docs[placed]) >= max_segments:
            if placed in open_rows:
                open_rows.remove(placed)

    R = max(len(rows_docs), 1)
    ids = np.full((R, row_len), pad_id, dtype=np.int32)
    pos = np.zeros((R, row_len), dtype=np.int32)
    seg = np.full((R, row_len), -1, dtype=np.int32)
    mapping: List[Tuple[int, int]] = [(0, 0)] * n
    for r, docs in enumerate(rows_docs):
        cursor = 0
        for slot, (doc_idx, toks) in enumerate(docs):
            m = len(toks)
            if m:
                ids[r, cursor : cursor + m] = toks
                pos[r, cursor : cursor + m] = np.arange(m)
                seg[r, cursor : cursor + m] = slot
            mapping[doc_idx] = (r, slot)
            cursor += m
    return ids, pos, seg, mapping
