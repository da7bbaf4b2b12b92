"""Two-level exact MIPS top-k (counterpart of ``rag_arc_tpu/ops/two_level.py``).

  pass 1 (CUDA kernel, ``ops/subtile_max.py``): the max score of every
    g-row sub-tile, dead rows masked → (B, N/g) f32.
  select: each query's top-k sub-tiles by max (``iterative_argmax_resid``).
  pass 2: gather those k·g rows, rescore them exactly, final top-k.

Exactness: a row of the true top-k lies in a sub-tile whose max is at
least the k-th best score, and at most k sub-tiles can reach that, so the
k selected sub-tiles hold the whole top-k; pass 2 rescores with true
scores. The producer is masked on every search, so the result is exact
with no certificate: the JAX package's positive-kth certificate and its
``lax.cond`` fallback (``two_level_stream.py::two_level_topk_certified``)
exist because its TPU stream kernel could not lower the mask.

Ties break as the JAX package breaks them: selection picks the lower
sub-tile index first, and the final top-k is a stable descending sort, so
equal candidates keep their candidate order as under ``lax.top_k``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from rag_arc_tpu_torch.ops.subtile_max import NEG, subtile_max
from rag_arc_tpu_torch.ops.topk import stable_topk


def iterative_argmax_resid(x: torch.Tensor, k: int, chunk: int = 512):
    """Indices of the k largest entries per row (score-descending, ties
    toward the lower index), a liveness flag per pick, and the row-max of
    the unselected remainder.

    A hierarchical tournament, ported literally: one pass builds per-chunk
    (max, argmax); each of the k steps reads the (B, n_chunks) summary,
    re-reads the one chunk it picked from with every earlier pick in it
    masked, and writes that chunk's new (max, argmax) back.
    ``torch.argmax`` returns the first maximal index, which keeps the
    reference's tie order."""
    b, c = x.shape
    w = min(chunk, c)
    if c % w:
        for cand in (512, 256, 128):
            if cand <= chunk and c % cand == 0:
                w = cand
                break
    n_chunks = -(-c // w)
    c_pad = n_chunks * w
    if c_pad != c:
        x = F.pad(x, (0, c_pad - c), value=NEG)
    xc = x.reshape(b, n_chunks, w)
    cmax = torch.amax(xc, dim=2)
    carg = torch.argmax(xc, dim=2)
    rows = torch.arange(b, device=x.device)
    in_chunk = torch.arange(w, device=x.device)[None, :]
    picked = torch.full((b, k), -1, dtype=torch.int64, device=x.device)
    lives = []
    for j in range(k):
        bc = torch.argmax(cmax, dim=1)
        best = cmax[rows, bc]
        # exhausted rows re-pick sentinel positions; clamp so gathers stay
        # in range (the liveness flag marks them dead either way)
        idx = torch.clamp(carg[rows, bc] + bc * w, max=c - 1)
        picked[:, j] = idx
        vals = xc[rows, bc, :]
        cols = bc[:, None] * w + in_chunk
        hit = torch.any(cols[:, None, :] == picked[:, :, None], dim=1)
        vals = torch.where(hit, NEG, vals)
        cmax[rows, bc] = torch.amax(vals, dim=1)
        carg[rows, bc] = torch.argmax(vals, dim=1)
        lives.append(best > NEG * 0.5)
    return picked, torch.stack(lives, dim=1), torch.amax(cmax, dim=1)


def select_rescore(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid: torch.Tensor,
    sub_max: torch.Tensor,
    k: int,
    g: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stages 2 and 3: select each query's top-k sub-tiles from the
    (B, N/g) maxima, gather and exactly rescore their rows, take the final
    top-k. ``queries`` are already normalized (cosine) and cast to the
    corpus dtype. Empty slots score NEG at position -1."""
    b = queries.shape[0]
    n_sub = sub_max.shape[1]
    k_tiles = min(k, n_sub)
    top_sub, sel_live, _ = iterative_argmax_resid(sub_max, k_tiles)
    offsets = torch.arange(g, device=corpus.device)
    rows = (top_sub[:, :, None] * g + offsets).reshape(b, k_tiles * g)
    cand = corpus[rows]                                   # (B, C, d)
    cand_valid = valid[rows] & sel_live.repeat_interleave(g, dim=1)
    # batched product in f32: bf16 products are exact, the sum is f32
    cscores = torch.bmm(cand.float(), queries.float()[:, :, None])[:, :, 0]
    cscores = torch.where(cand_valid, cscores, NEG)
    k_out = min(k, cscores.shape[1])
    s, ci = stable_topk(cscores, k_out)
    pos = torch.gather(rows, 1, ci)
    pos = torch.where(s <= NEG * 0.5, -1, pos)
    if k_out < k:
        s = F.pad(s, (0, k - k_out), value=NEG)
        pos = F.pad(pos, (0, k - k_out), value=-1)
    return s, pos


def prepare_queries(
    queries: torch.Tensor, dtype: torch.dtype, metric: str
) -> torch.Tensor:
    """Normalize (cosine) in f32, then cast to the corpus dtype — the
    queries both producer passes and the rescore see."""
    if metric not in ("cosine", "ip"):
        raise NotImplementedError(
            f"two-level search supports cosine/ip, not {metric!r} "
            "(ROADMAP Queue 2: the l2 sub-tile-max kernel)"
        )
    queries = queries.float()
    if metric == "cosine":
        norm = torch.sqrt(torch.sum(queries * queries, dim=-1, keepdim=True))
        queries = queries / torch.clamp(norm, min=1e-12)
    return queries.to(dtype).contiguous()


def two_level_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    g: int = 16,
    metric: str = "cosine",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, d) × (N, d) → exact top-k (scores (B, k) f32, positions (B, k)
    int64). N must be a multiple of ``g``; ``valid`` masks padding and
    tombstones; for cosine the corpus must be pre-normalized."""
    qc = prepare_queries(queries, corpus.dtype, metric)
    sub = subtile_max(qc, corpus, valid, g)
    return select_rescore(qc, corpus, valid, sub, k, g)
