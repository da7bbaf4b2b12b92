"""Exact top-k of unit queries over the corpus, in blocks.

Each block of corpus rows is made again from the corpus seed, normalized
in float32 and rounded to the stored type (the configuration's bf16), then
scored against the queries in float32. The scores of any extra positions
(the served answers) are read off the same blocks.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from bench_torch import data
from bench_torch.reference import f32_mm


def stored_rows(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows as the index holds them: unit length in f32, then ``dtype``."""
    x = x / x.norm(dim=1, keepdim=True).clamp(min=1e-12)
    return x.to(dtype).float()


@torch.no_grad()
def exact_topk(queries: torch.Tensor, k: int, corpus: dict, device,
               extra: Optional[Sequence[Sequence[int]]] = None,
               mm=f32_mm) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``queries`` (B, d) unit f32 → (scores (B, k) descending, positions
    (B, k), extra_scores (B, E)) where ``extra`` lists E positions a query
    (-1 for none; their score is -inf)."""
    b = queries.shape[0]
    n, dim, dtype = corpus["rows"], corpus["dim"], getattr(torch, corpus["dtype"])
    best_s = torch.full((b, k), float("-inf"), device=device)
    best_p = torch.full((b, k), -1, dtype=torch.long, device=device)
    ex = torch.tensor(extra if extra is not None else [[-1]] * b, device=device, dtype=torch.long)
    ex_s = torch.full(ex.shape, float("-inf"), device=device)
    for blk in range(data.n_blocks(n, data.VECTOR_BLOCK)):
        lo = blk * data.VECTOR_BLOCK
        rows = stored_rows(data.vector_block(torch, corpus["seed"], blk, n, dim, device), dtype)
        s = mm(queries, rows.t())
        hit = (ex >= lo) & (ex < lo + rows.shape[0])
        if hit.any():
            local = torch.where(hit, ex - lo, 0)
            ex_s = torch.where(hit, torch.gather(s, 1, local), ex_s)
        kk = min(k, rows.shape[0])
        s_top, p_top = torch.topk(s, kk, dim=1)
        cat_s = torch.cat([best_s, s_top], 1)
        cat_p = torch.cat([best_p, p_top + lo], 1)
        best_s, sel = torch.topk(cat_s, k, dim=1)
        best_p = torch.gather(cat_p, 1, sel)
    return best_s, best_p, ex_s
