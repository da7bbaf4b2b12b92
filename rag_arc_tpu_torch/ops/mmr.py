"""Maximal-marginal-relevance selection.

The port's own copy of ``rag_arc_tpu/ops/mmr.py``, its behaviour unchanged, so
the port imports nothing of the JAX package.

Parity with the reference's ``_mmr_select`` (``VectorStore_Faiss.py:16-62``):
greedy selection maximizing ``λ·sim(q, d) − (1−λ)·max_{s∈selected} sim(d, s)``
over ``fetch_k`` candidates. Unlike the reference — which *re-embeds the
candidate documents per query* (``VectorStore_Faiss.py:300-304``, a noted
inefficiency) — candidate vectors are gathered straight from the HBM index,
so MMR costs one (fetch_k × dim) gather plus the tiny greedy loop.

The greedy loop is sequential with a data-dependent argmax; at fetch_k ≤ a
few hundred it is host-side numpy (device dispatch overhead would dominate
a kernel). All vectors are unit-normalized by the index for cosine.
"""

from __future__ import annotations

from typing import List

import numpy as np


def mmr_select(
    query_vec: np.ndarray,
    candidate_vecs: np.ndarray,
    k: int,
    lambda_mult: float = 0.5,
) -> List[int]:
    """Return indices (into candidates) of the MMR-selected subset, in
    selection order."""
    if not 0.0 <= lambda_mult <= 1.0:
        raise ValueError(f"lambda_mult must be in [0, 1], got {lambda_mult}")
    n = candidate_vecs.shape[0]
    if n == 0 or k <= 0:
        return []
    k = min(k, n)

    def _unit(x):
        norm = np.linalg.norm(x, axis=-1, keepdims=True)
        return x / np.maximum(norm, 1e-12)

    q = _unit(np.asarray(query_vec, dtype=np.float32).reshape(-1))
    cand = _unit(np.asarray(candidate_vecs, dtype=np.float32))
    rel = cand @ q  # (n,) relevance to query
    sim = cand @ cand.T  # (n, n) pairwise

    selected: List[int] = [int(np.argmax(rel))]
    max_sim_to_sel = sim[:, selected[0]].copy()
    while len(selected) < k:
        mmr = lambda_mult * rel - (1.0 - lambda_mult) * max_sim_to_sel
        mmr[selected] = -np.inf
        nxt = int(np.argmax(mmr))
        selected.append(nxt)
        np.maximum(max_sim_to_sel, sim[:, nxt], out=max_sim_to_sel)
    return selected
