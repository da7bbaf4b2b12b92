"""BM25 scoring on the device (counterpart of ``rag_arc_tpu/ops/bm25.py``).

Two device layouts, both exact:

- doc-major (the ``device`` backend): ``doc_terms (N, Dmax) int32``
  holds each document's unique term ids padded with ``DOC_PAD``, and
  ``doc_weights (N, Dmax) f32`` the fully precomputed per-term BM25
  weight ``idf(t) · tf·(k1+1) / (tf + k1·(1−b+b·|D|/avgdl))``. A query
  batch scans its term slots with a masked compare-and-accumulate,
  chunked over rows so that no (B, N, Dmax) tensor exists whole.
- head-dense / tail-sparse (the ``hybrid`` backend): the head terms'
  weights are a dense (H, N) matrix scored by one f32 matmul; the tail
  terms' postings stay on the device, and each query ships only
  (start, len, count) per tail term. Slabs of postings are gathered and
  scatter-added into the (B, N) head scores, or, for head-free batches,
  sorted by doc id and summed per doc by a segmented scan.

The top-k over a (B, N) score array (:func:`select_topk`) takes the
select kernel ``csrc/subtile_select.cu`` on a CUDA tensor and the JAX
package's tournament on a CPU tensor; both are exact, with ties to the
lowest index as ``jnp.argmax`` gives them. The IDF follows BM25Okapi:
``ln((N−df+0.5)/(df+0.5))`` with negative values floored to
``epsilon · mean(idf)``. ``compute_idf``, ``compute_doc_weights`` and
``numpy_bm25_oracle`` are numpy, bit-equal to the JAX package's.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rag_arc_tpu_torch.ops.subtile_select import iterative_argmax_resid
from rag_arc_tpu_torch.ops.two_level import _candidates, _final_topk

DOC_PAD = -1  # padding term id in doc_terms
QUERY_PAD = -2  # padding term id in query slots (never matches DOC_PAD)

# elements of one (B, rows, Dmax) compare in the doc-major scan
SCAN_CHUNK_ELEMS = 1 << 25


def compute_idf(doc_freq: np.ndarray, n_docs: int, epsilon: float = 0.25) -> np.ndarray:
    """BM25Okapi IDF with the negative-IDF epsilon floor.

    The floor is ``epsilon * mean(idf)`` where the mean runs over every
    CORPUS term (df ≥ 1), negatives included, as BM25Okapi does. df=0
    slots (filler ids in sparse/partial-vocab CSR builds) are excluded
    from the mean."""
    idf = np.log((n_docs - doc_freq + 0.5) / (doc_freq + 0.5))
    present = doc_freq > 0
    avg_idf = idf[present].mean() if present.any() else 1.0
    eps_floor = epsilon * avg_idf
    return np.where(idf < 0, eps_floor, idf).astype(np.float32)


def compute_doc_weights(
    tf: np.ndarray,
    idf_per_slot: np.ndarray,
    doc_len: np.ndarray,
    avgdl: float,
    k1: float = 1.5,
    b: float = 0.75,
) -> np.ndarray:
    """Precompute the document-side BM25 weight for every (doc, term) slot.

    ``tf (N, Dmax)``: term frequency per slot; ``idf_per_slot (N, Dmax)``:
    idf of the slot's term; ``doc_len (N,)``: document lengths in tokens.
    """
    norm = k1 * (1.0 - b + b * doc_len[:, None] / max(avgdl, 1e-9))
    return (idf_per_slot * tf * (k1 + 1.0) / (tf + norm)).astype(np.float32)


# -- the f32 head matmul ------------------------------------------------------

_tf32_lock = threading.Lock()
_tf32_users = 0
_tf32_saved = False


@contextlib.contextmanager
def full_f32_matmul():
    """cuBLAS matmuls in full f32 inside the block, whatever the global
    TF32 flag (``torch.backends.cuda.matmul.allow_tf32`` or
    ``set_float32_matmul_precision``) says: a TF32 head rounds its weights
    to 10 mantissa bits and reorders near-ties against the host scorer.
    The flag is process-global, so nested and concurrent blocks share one
    saved value: the first to enter turns TF32 off, the last to leave
    puts the caller's setting back."""
    global _tf32_users, _tf32_saved
    with _tf32_lock:
        if _tf32_users == 0:
            _tf32_saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
        _tf32_users += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_users -= 1
            if _tf32_users == 0:
                torch.backends.cuda.matmul.allow_tf32 = _tf32_saved


def head_scores(q_head: torch.Tensor, w_head: torch.Tensor) -> torch.Tensor:
    """(B, N) f32 scores of the head terms: ``q_head (B, H)`` query-term
    counts times the f32 ``w_head (H, N)``, never in TF32 (the JAX package
    asks ``Precision.HIGHEST`` for an f32 head)."""
    with full_f32_matmul():
        return q_head.float() @ w_head


# -- the doc-major scan -------------------------------------------------------


def bm25_scores_kernel(
    doc_terms: torch.Tensor,
    doc_weights: torch.Tensor,
    query_terms: torch.Tensor,
    query_counts: torch.Tensor,
) -> torch.Tensor:
    """(B, N) BM25 scores.

    ``query_terms (B, QMAX) int32`` padded with QUERY_PAD;
    ``query_counts (B, QMAX) float32``: query-term multiplicity (rank_bm25
    scores each occurrence of a repeated query term). Slots are added in
    order, as the JAX scan adds them; rows go in chunks of at most
    ``SCAN_CHUNK_ELEMS`` compare elements."""
    b, qmax = query_terms.shape
    n, dmax = doc_terms.shape
    scores = torch.zeros((b, n), dtype=torch.float32, device=doc_weights.device)
    rows = max(1, SCAN_CHUNK_ELEMS // max(b * dmax, 1))
    qc = query_counts.float()
    for r0 in range(0, n, rows):
        terms = doc_terms[None, r0 : r0 + rows]
        weights = doc_weights[None, r0 : r0 + rows]
        acc = scores[:, r0 : r0 + rows]
        for s in range(qmax):
            match = terms == query_terms[:, s, None, None]
            contrib = torch.where(match, weights, 0.0).sum(dim=-1)
            acc += qc[:, s, None] * contrib
    return scores


def bm25_topk(
    doc_terms: torch.Tensor,
    doc_weights: torch.Tensor,
    valid: torch.Tensor,
    query_terms: torch.Tensor,
    query_counts: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    scores = bm25_scores_kernel(doc_terms, doc_weights, query_terms, query_counts)
    scores.masked_fill_(~valid[None, :], float("-inf"))
    return select_topk(scores, k)


# -- top-k over a (B, N) score array --------------------------------------------


def select_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k (values (B, k), indices (B, k)) of a (B, N) f32 score
    array, 1 ≤ k ≤ N, ties to the lowest index.

    Where a group width g in (512, 256, 128) divides N and k ≤ g, one
    pass reduces each g columns to their max and the top-k lies in the k
    groups with the largest maxima (a group's max bounds every element in
    it, so the groups ranked below k others that reach the k-th score
    cannot hold it). Else the k largest are picked from the raw scores.

    A CUDA tensor picks groups (or entries) with the select kernel
    (``ops/two_level.py::_candidates``, one ``subtile_select.cu``
    launch), gathers the k·g raw scores in index order and takes
    ``_final_topk``: -inf slots come back at index -1. A CPU tensor runs
    the JAX package's tournament (``_coarse_topk`` / ``_iter_topk``),
    whose -inf slots keep an index; callers map -inf to -1 either way."""
    if scores.device.type == "cpu":
        for g in (512, 256, 128):
            if scores.shape[1] % g == 0 and k <= g:
                return _coarse_topk(scores, k, g)
        return _iter_topk(scores, k)
    if scores.device.type != "cuda":
        raise ValueError(f"no select kernel for device {scores.device}")
    b, n = scores.shape
    for g in (512, 256, 128):
        if n % g == 0 and k <= g:
            sub = torch.amax(scores.view(b, n // g, g), dim=2)
            rows, _ = _candidates(sub, k, g)
            # candidates in index order, so the stable final top-k breaks
            # ties toward the lowest index
            rows = torch.sort(rows, dim=1).values
            return _final_topk(torch.gather(scores, 1, rows), rows, k, pad=False)
    return _kernel_topk(scores, k)


def _kernel_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row by the select kernel, in pick
    order (value descending, index ascending); -inf slots at index -1."""
    picked, _, _ = iterative_argmax_resid(scores, k)
    vals = torch.gather(scores, 1, picked)
    return vals, torch.where(torch.isneginf(vals), -1, picked)


def _iter_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-pass argmax top-k over (B, N), the JAX package's plain form."""
    sc = scores.clone()
    rows = torch.arange(sc.shape[0], device=sc.device)
    vals, idxs = [], []
    for _ in range(k):
        idx = torch.argmax(sc, dim=1)
        vals.append(sc[rows, idx])
        idxs.append(idx)
        sc[rows, idx] = float("-inf")
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1)


def _coarse_topk(scores: torch.Tensor, k: int, g: int = 256):
    """Exact two-level top-k over (B, N), N % g == 0, the JAX package's
    tournament: one pass reduces groups of g columns to their max; each of
    the k steps takes the best group, resolves its winner among the g raw
    scores (earlier picks masked) and lowers that group's cached max.
    Ties go to the lowest index, as ``torch.argmax`` takes the first."""
    b, n = scores.shape
    grouped = scores.reshape(b, n // g, g)
    sub = torch.amax(grouped, dim=2)
    rows = torch.arange(b, device=scores.device)
    span = torch.arange(g, device=scores.device)
    picked = torch.full((b, k), -1, dtype=torch.int64, device=scores.device)
    vals, idxs = [], []
    for _ in range(k):
        gidx = torch.argmax(sub, dim=1)
        grp = grouped[rows, gidx]                          # (B, g) raw
        base = gidx * g
        absidx = base[:, None] + span[None, :]
        dup = torch.any(absidx[:, :, None] == picked[:, None, :], dim=-1)
        grp = torch.where(dup, float("-inf"), grp)
        e = torch.argmax(grp, dim=1)
        vals.append(grp[rows, e])
        chosen = base + e
        grp[rows, e] = float("-inf")
        sub[rows, gidx] = torch.amax(grp, dim=1)
        picked = torch.cat([picked[:, 1:], chosen[:, None]], dim=1)
        idxs.append(chosen)
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1)


def _topk_window(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of a (B, W) candidate window in pick order: the
    select kernel on a CUDA tensor, ``_iter_topk`` on a CPU one."""
    if scores.device.type == "cpu":
        return _iter_topk(scores, k)
    if scores.device.type != "cuda":
        raise ValueError(f"no select kernel for device {scores.device}")
    return _kernel_topk(scores, k)


# -- the hybrid programs --------------------------------------------------------


def _slab_add(scores, tail_docs, tail_w, starts, lens, counts, qids, width):
    """Gather one width bucket's slabs (each a contiguous window of the
    postings; the arrays carry a max-width zero pad so no window runs off
    the end) and add their in-list weights × query counts into
    ``scores[qid, doc]``. Pad slots add 0 to (query qid, doc at start)."""
    span = torch.arange(width, device=scores.device)
    idx = starts.long()[..., None] + span
    docs = tail_docs[idx].long()
    w = torch.where(span < lens[..., None], tail_w[idx] * counts.float()[..., None], 0.0)
    n = scores.shape[1]
    flat = (qids.long()[..., None] * n + docs).reshape(-1)
    scores.view(-1).index_add_(0, flat, w.reshape(-1))


def bm25_hybrid_topk(
    w_head: torch.Tensor,     # (H, N) per-doc weights of the H head terms
    valid: torch.Tensor,      # (N,) bool
    q_head: torch.Tensor,     # (B, H) f32 query-term multiplicities
    tail_docs: torch.Tensor,  # (nnz + pad,) int32 postings doc ids
    tail_w: torch.Tensor,     # (nnz + pad,) f32 postings weights
    starts: torch.Tensor,     # (B, T) int32 posting-list starts per tail term
    lens: torch.Tensor,       # (B, T) int32 posting-list lengths
    counts: torch.Tensor,     # (B, T) f32 query-term multiplicities
    k: int,
    max_df: int,              # bound on any tail term's df (the slab width)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact hybrid BM25 top-k with one slab width and per-query slabs
    (the index's entry is :func:`bm25_hybrid_topk_flat`). Tail weights are
    added into the head scores, so a doc matching several tail terms of a
    query carries their sum before the one top-k."""
    b = q_head.shape[0]
    scores = head_scores(q_head, w_head)
    scores.masked_fill_(~valid[None, :], float("-inf"))
    qids = torch.arange(b, device=scores.device)[:, None].expand_as(starts)
    _slab_add(scores, tail_docs, tail_w, starts, lens, counts, qids, max_df)
    return select_topk(scores, k)


def bm25_hybrid_topk_flat(
    w_head: torch.Tensor,     # (H, N) per-doc weights of the H head terms
    valid: torch.Tensor,      # (N,) bool
    tail_docs: torch.Tensor,  # (nnz + pad,) int32 postings doc ids
    tail_w: torch.Tensor,     # (nnz + pad,) f32 postings weights
    packed: torch.Tensor,     # 1-D int32, layout below
    k: int,
    b: int,                   # batch rows
    h: int,
    widths: Sequence[int],    # slab width per bucket (ascending)
    ss: Sequence[int],        # slab count per bucket, shared by the batch
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hybrid top-k with width-bucketed slabs pooled across the batch:
    each slab carries its owner query's row, so the slot count scales with
    the live slabs, not with b × the batch's largest per-query count.

      packed = [q_head (b·h) | per bucket: starts(s) lens(s) counts(s) qids(s)]

    Padding slabs carry start=len=count=qid=0: their weights are zero."""
    q_head = packed[: b * h].reshape(b, h)
    scores = head_scores(q_head, w_head)
    scores.masked_fill_(~valid[None, :], float("-inf"))
    o = b * h
    for width, s in zip(widths, ss):
        starts = packed[o : o + s]
        lens = packed[o + s : o + 2 * s]
        counts = packed[o + 2 * s : o + 3 * s]
        qids = packed[o + 3 * s : o + 4 * s]
        o += 4 * s
        _slab_add(scores, tail_docs, tail_w, starts, lens, counts, qids, width)
    return select_topk(scores, k)


def bm25_tail_only_topk(
    tail_docs: torch.Tensor,
    tail_w: torch.Tensor,
    packed: torch.Tensor,     # (B, 3·Σts) int32: the hybrid layout with h=0
    k: int,
    widths: Sequence[int],
    ts: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact BM25 top-k for head-free batches without a (B, N) score
    array: gather the tail slabs, sort the candidates by doc id (stable;
    weights carried along), and sum each doc's contributions with a
    segmented inclusive scan (Hillis-Steele, log₂W steps: ids are sorted,
    so id equality at any shift distance is the segment test). Run ends
    hold the exact per-doc totals; the top-k is picked from that (B, W)
    window. Pad slots carry id -1 (sorted first, never returned) and
    empty result slots come back as (-inf, -1)."""
    b = packed.shape[0]
    dev = packed.device
    cands, wparts = [], []
    o = 0
    for width, t in zip(widths, ts):
        starts = packed[:, o : o + t].long()
        lens = packed[:, o + t : o + 2 * t]
        counts = packed[:, o + 2 * t : o + 3 * t].float()
        o += 3 * t
        span = torch.arange(width, device=dev)
        in_list = span < lens[:, :, None]
        idx = starts[:, :, None] + span
        cands.append(torch.where(in_list, tail_docs[idx].long(), -1).reshape(b, -1))
        wparts.append(torch.where(in_list, tail_w[idx] * counts[:, :, None], 0.0).reshape(b, -1))
    ids = torch.cat(cands, dim=1)
    w = torch.cat(wparts, dim=1)
    ids, order = torch.sort(ids, dim=1, stable=True)
    acc = torch.gather(w, 1, order)

    big = ids.shape[1]
    dist = 1
    while dist < big:
        same = ids == F.pad(ids, (dist, 0), value=-2)[:, :big]
        shifted = F.pad(acc, (dist, 0))[:, :big]
        acc = acc + torch.where(same, shifted, 0.0)
        dist *= 2
    nxt = F.pad(ids[:, 1:], (0, 1), value=-2)
    score = torch.where((ids != nxt) & (ids >= 0), acc, float("-inf"))
    s, idx = _topk_window(score, min(k, big))
    p = torch.gather(ids, 1, idx)
    p = torch.where(torch.isneginf(s), -1, p)
    if s.shape[1] < k:
        pad = k - s.shape[1]
        s = F.pad(s, (0, pad), value=float("-inf"))
        p = F.pad(p, (0, pad), value=-1)
    return s, p


def numpy_bm25_oracle(
    tokenized_docs: list[list[str]],
    tokenized_query: list[str],
    k1: float = 1.5,
    b: float = 0.75,
    epsilon: float = 0.25,
) -> np.ndarray:
    """Straightforward host BM25Okapi for oracle testing (re-derived from
    the published formula)."""
    n = len(tokenized_docs)
    doc_len = np.array([len(d) for d in tokenized_docs], dtype=np.float64)
    avgdl = doc_len.mean() if n else 0.0
    vocab: dict[str, int] = {}
    for doc in tokenized_docs:
        for t in doc:
            vocab.setdefault(t, len(vocab))
    df = np.zeros(len(vocab))
    tfs = []
    for doc in tokenized_docs:
        tf: dict[int, int] = {}
        for t in doc:
            tf[vocab[t]] = tf.get(vocab[t], 0) + 1
        tfs.append(tf)
        for tid in tf:
            df[tid] += 1
    idf = compute_idf(df, n, epsilon)
    scores = np.zeros(n)
    for q in tokenized_query:
        tid = vocab.get(q)
        if tid is None:
            continue
        for i, tf in enumerate(tfs):
            f = tf.get(tid, 0)
            if f:
                norm = k1 * (1 - b + b * doc_len[i] / avgdl)
                scores[i] += idf[tid] * f * (k1 + 1) / (f + norm)
    return scores
