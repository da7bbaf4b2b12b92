"""Two-level exact MIPS top-k (counterpart of ``rag_arc_tpu/ops/two_level.py``).

  pass 1 (the producer): the max score of every g-row sub-tile, dead rows
    masked → (B, N/g) f32. ``producer`` picks it, as in the JAX package's
    ``two_level_stream.py::_produce``:
      "stream" (the default): the CUDA kernels of ``ops/subtile_max.py``
        (bf16/f32: cosine, ip, l2) and ``ops/subtile_max_i8.py`` (int8);
      "stream_piped": the pipelined CUDA kernel of
        ``ops/subtile_max_piped.py`` (cosine/ip; int8 with block scales);
      "scan": :func:`subtile_max_scan`, plain torch over row tiles.
    Every producer is masked, so every producer gives the same ids.
  select: each query's top-k sub-tiles by max (``iterative_argmax_resid``).
  pass 2: gather those k·g rows, rescore them exactly, final top-k.

Exactness: a row of the true top-k lies in a sub-tile whose max is at
least the k-th best score, and at most k sub-tiles can reach that, so the
k selected sub-tiles hold the whole top-k; pass 2 rescores with true
scores. The producer is masked on every search, so the result is exact
with no certificate: the JAX package's positive-kth certificate and its
``lax.cond`` fallback (``two_level_stream.py::two_level_topk_certified``)
exist because its TPU stream kernel could not lower the mask.

The same holds for int8 (``two_level_topk_i8``), and the JAX package's
certified int8 path (``two_level_stream.py::two_level_topk_certified_i8``)
is not ported as a certificate either. With block scales (one scale per
``QUANT_BLOCK`` rows, which every g here divides) the masked kernel's
sub-tile values are the exact scaled sub-tile maxima under the quantized
metric. The certificate's upper bound ``ub`` equals them on every sub-tile
without dead rows; elsewhere ``ub`` can only be higher, because zeroed
dead rows score 0 there. So the masked kernel's selection is the exact
one the certificate sets out to prove, and nothing is left to certify.

Ties break as the JAX package breaks them: selection picks the lower
sub-tile index first, and the final top-k is a stable descending sort, so
equal candidates keep their candidate order as under ``lax.top_k``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rag_arc_tpu_torch.ops.subtile_max import NEG, subtile_max, subtile_max_plain
from rag_arc_tpu_torch.ops.subtile_max_i8 import subtile_max_i8, subtile_max_i8_plain
from rag_arc_tpu_torch.ops.subtile_max_piped import subtile_max_piped
from rag_arc_tpu_torch.ops.topk import stable_topk

# -- quantization -------------------------------------------------------------


def quantize_rows(vectors, axis: int = -1):
    """Symmetric per-row int8 quantization: returns (int8 codes, f32
    scales) with ``codes * scale ≈ vectors``. numpy, as in the JAX
    package, so codes and scales are bit-identical with its."""
    vectors = np.asarray(vectors, dtype=np.float32)
    amax = np.abs(vectors).max(axis=axis, keepdims=True)
    scale = np.maximum(amax, 1e-12) / 127.0
    codes = np.clip(np.rint(vectors / scale), -127, 127).astype(np.int8)
    return codes, scale.squeeze(axis).astype(np.float32)


def quantize_rows_blocked(vectors, block: int = 32):
    """Symmetric int8 quantization with ONE shared scale per ``block``
    consecutive rows. Pads the row count up to a block multiple (zero
    rows, scale shared with their block). When every row of a sub-tile
    shares its scale, the raw int32 sub-tile max times that scale is the
    exact scaled sub-tile max.

    Returns (codes (n_pad, d) int8, scales (n_pad,) f32 expanded per row).
    A torch tensor is quantized where it lies and gives torch tensors; a
    numpy array goes through the same steps on the CPU and gives numpy
    arrays. ``torch.round`` rounds half to even like the JAX package's
    ``np.rint``, so the codes and scales are bit-identical with its.
    """
    if not isinstance(vectors, torch.Tensor):
        host = np.asarray(vectors, dtype=np.float32)
        codes, scales = quantize_rows_blocked(
            torch.from_numpy(host if host.flags.writeable else host.copy()), block)
        return codes.numpy(), scales.numpy()
    vectors = vectors.float()
    n, d = vectors.shape
    n_pad = -(-n // block) * block
    blocks = F.pad(vectors, (0, 0, 0, n_pad - n)).reshape(n_pad // block, block, d)
    amax = torch.amax(torch.abs(blocks), dim=(1, 2), keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return codes.reshape(n_pad, d), scale[:, 0, 0].repeat_interleave(block)


def row_norm(x: torch.Tensor) -> torch.Tensor:
    """(B, 1) f32 L2 norm of each row, summed in the order XLA's CPU
    reduction takes for widths that are multiples of 32: each 32-column
    chunk left to right, then the chunk sums left to right. The query
    codes and scales then come out bit-identical with the JAX package's on
    the CPU (other widths can differ from it in the last bit)."""
    sq = x.float() * x.float()
    b, d = sq.shape
    pad = -d % 32
    if pad:
        sq = F.pad(sq, (0, pad))  # adding +0.0 leaves every sum unchanged
    chunks = sq.reshape(b, -1, 32)
    part = chunks[:, :, 0]
    for i in range(1, 32):
        part = part + chunks[:, :, i]
    total = part[:, 0]
    for c in range(1, part.shape[1]):
        total = total + part[:, c]
    return torch.sqrt(total)[:, None]


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows over their :func:`row_norm` (zero rows stay zero), in f32."""
    return x.float() / torch.clamp(row_norm(x), min=1e-12)


def quantize_queries(queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize + symmetric per-query int8 quantization (the query-side
    half of the int8 metric). Returns (codes (B, d) int8, scale (B, 1)).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    qn = normalize_rows(queries)
    qmax = torch.amax(torch.abs(qn), dim=-1, keepdim=True)
    qscale = torch.clamp(qmax, min=1e-12) / 127.0
    q_i8 = torch.clamp(torch.round(qn / qscale), -127, 127).to(torch.int8)
    return q_i8, qscale


# -- producers -----------------------------------------------------------------

PRODUCERS = ("stream", "stream_piped", "scan")


def subtile_max_scan(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid: torch.Tensor,
    g: int = 16,
    tile_n: int = 2048,
    sqnorm: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    block_scales: bool = True,
) -> torch.Tensor:
    """(B, N/g) sub-tile maxima by a plain torch loop over ``tile_n``-row
    tiles, so no (B, N) score matrix exists at once: the counterpart of
    ``rag_arc_tpu/ops/two_level.py::subtile_max_scan`` (``producer="scan"``).
    Each tile takes the stream kernels' plain versions, so it is masked
    like them (the JAX scan is maskless and relies on zeroed dead rows).
    int8 corpora need their per-row ``scale``; l2 takes ``sqnorm``."""
    if tile_n % g:
        raise ValueError(f"tile_n {tile_n} not a multiple of g {g}")
    n = corpus.shape[0]
    if n % g:
        raise ValueError(f"corpus rows {n} not a multiple of g {g}")
    out = torch.empty((queries.shape[0], n // g), dtype=torch.float32,
                      device=corpus.device)
    for start in range(0, n, tile_n):
        stop = min(start + tile_n, n)
        if corpus.dtype == torch.int8:
            sub = subtile_max_i8_plain(queries, corpus[start:stop], scale[start:stop],
                                       valid[start:stop], g, block_scales)
        else:
            sub = subtile_max_plain(queries, corpus[start:stop], valid[start:stop], g,
                                    None if sqnorm is None else sqnorm[start:stop])
        out[:, start // g : stop // g] = sub
    return out


def produce(
    producer: str,
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid: torch.Tensor,
    g: int,
    tile_n: int = 2048,
    sqnorm: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    block_scales: bool = True,
) -> torch.Tensor:
    """Pass 1 by the chosen producer (``PRODUCERS``): (B, N/g) f32 masked
    sub-tile maxima. ``sqnorm`` selects l2; an int8 corpus takes query codes
    and its row ``scale``. ``tile_n`` is the scan's row tile."""
    if producer == "stream":
        if corpus.dtype == torch.int8:
            return subtile_max_i8(queries, corpus, scale, valid, g, block_scales=block_scales)
        return subtile_max(queries, corpus, valid, g, sqnorm=sqnorm)
    if producer == "stream_piped":
        if sqnorm is not None:
            raise ValueError("the pipelined producer takes cosine/ip, not l2")
        if corpus.dtype == torch.int8 and not block_scales:
            raise ValueError("the pipelined producer's int8 mode needs block scales")
        return subtile_max_piped(queries, corpus, valid, g, scale=scale)
    if producer == "scan":
        return subtile_max_scan(queries, corpus, valid, g, tile_n, sqnorm, scale,
                                block_scales)
    raise ValueError(f"unknown producer {producer!r}; one of {PRODUCERS}")


# -- select -------------------------------------------------------------------


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


def _candidates(sub_max: torch.Tensor, k: int, g: int):
    """Rows of each query's top-k sub-tiles, (B, k_tiles·g) in pick order,
    and the per-row liveness of the picks."""
    b = sub_max.shape[0]
    k_tiles = min(k, sub_max.shape[1])
    top_sub, sel_live, _ = iterative_argmax_resid(sub_max, k_tiles)
    offsets = torch.arange(g, device=sub_max.device)
    rows = (top_sub[:, :, None] * g + offsets).reshape(b, k_tiles * g)
    return rows, sel_live.repeat_interleave(g, dim=1)


def _final_topk(
    cscores: torch.Tensor, rows: torch.Tensor, k: int, pad: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable top-k of candidate scores; positions of empty slots are -1,
    padded out to k columns with NEG / -1 when ``pad``."""
    k_out = min(k, cscores.shape[1])
    s, ci = stable_topk(cscores, k_out)
    pos = torch.gather(rows, 1, ci)
    pos = torch.where(s <= NEG * 0.5, -1, pos)
    if pad and k_out < k:
        s = F.pad(s, (0, k - k_out), value=NEG)
        pos = F.pad(pos, (0, k - k_out), value=-1)
    return s, pos


# -- bf16 / f32 ---------------------------------------------------------------


def select_rescore(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid: torch.Tensor,
    sub_max: torch.Tensor,
    k: int,
    g: int,
    metric: str = "cosine",
    sqnorm: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stages 2 and 3: select each query's top-k sub-tiles from the
    (B, N/g) maxima, gather and exactly rescore their rows, take the final
    top-k. ``queries`` are already normalized (cosine) and cast to the
    corpus dtype; l2 needs the corpus ``sqnorm``. Empty slots score NEG at
    position -1."""
    rows, live = _candidates(sub_max, k, g)
    cand = corpus[rows]                                   # (B, C, d)
    cand_valid = valid[rows] & live
    # batched product in f32: bf16 products are exact, the sum is f32
    q32 = queries.float()
    cscores = torch.bmm(cand.float(), q32[:, :, None])[:, :, 0]
    if metric == "l2":
        q_sq = torch.sum(q32 * q32, dim=1, keepdim=True)
        cscores = -(q_sq - 2.0 * cscores + sqnorm[rows])
    cscores = torch.where(cand_valid, cscores, NEG)
    return _final_topk(cscores, rows, k)


def prepare_queries(
    queries: torch.Tensor, dtype: torch.dtype, metric: str
) -> torch.Tensor:
    """Normalize (cosine) in f32, then cast to the corpus dtype — the
    queries both producer passes and the rescore see. ip and l2 queries
    are cast as they are."""
    if metric not in ("cosine", "ip", "l2"):
        raise ValueError(f"unknown metric {metric!r}")
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
    sqnorm: Optional[torch.Tensor] = None,
    producer: str = "stream",
    tile_n: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, d) × (N, d) → exact top-k (scores (B, k) f32, positions (B, k)
    int64). N must be a multiple of ``g``; ``valid`` masks padding and
    tombstones; for cosine the corpus must be pre-normalized; l2 needs the
    corpus's f32 squared norms ``sqnorm``. ``producer`` picks pass 1 (see
    the module docstring); ``tile_n`` is the "scan" producer's row tile."""
    if metric == "l2" and sqnorm is None:
        raise ValueError("l2 two-level search needs the corpus sqnorm")
    if producer not in PRODUCERS:
        raise ValueError(f"unknown producer {producer!r}; one of {PRODUCERS}")
    qc = prepare_queries(queries, corpus.dtype, metric)
    sub = produce(producer, qc, corpus, valid, g, tile_n,
                  sqnorm=sqnorm if metric == "l2" else None)
    return select_rescore(qc, corpus, valid, sub, k, g, metric, sqnorm)


# -- int8 ---------------------------------------------------------------------


def rescore_i8(
    q_i8: torch.Tensor,
    corpus: torch.Tensor,
    row_scale: torch.Tensor,
    valid: torch.Tensor,
    sub_max: torch.Tensor,
    k: int,
    g: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select the top-k sub-tiles, gather their rows and rescore them
    exactly under the per-row int8 metric. Returns RAW scores
    (codes·codes × row_scale, no per-query fold), k_out ≤ k columns.

    The dot runs in f32 on integer values: exact for d ≤ 1040
    (|dot| ≤ d·127² < 2²⁴), so it equals the JAX package's int32 dot."""
    rows, live = _candidates(sub_max, k, g)
    cand = corpus[rows].float()                           # (B, C, d)
    ci = torch.bmm(cand, q_i8.float()[:, :, None])[:, :, 0]
    cscores = ci * row_scale[rows]
    cscores = torch.where(valid[rows] & live, cscores, NEG)
    return _final_topk(cscores, rows, k, pad=False)


def fold_qscale(
    s: torch.Tensor, pos: torch.Tensor, qscale: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold the per-query quantization scale into raw int8-metric scores
    (reporting them in the cosine range) and pad out to k columns."""
    s = torch.where(s <= NEG * 0.5, s, s * qscale)
    if s.shape[1] < k:
        pad = k - s.shape[1]
        s = F.pad(s, (0, pad), value=NEG)
        pos = F.pad(pos, (0, pad), value=-1)
    return s, pos


def select_rescore_i8(
    q_i8: torch.Tensor,
    qscale: torch.Tensor,
    corpus: torch.Tensor,
    row_scale: torch.Tensor,
    valid: torch.Tensor,
    sub_max: torch.Tensor,
    k: int,
    g: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Int8 stages 2 and 3: sub-tile select from the (B, N/g) maxima,
    gather + rescore with the same int8 arithmetic as pass 1, fold the
    query scale, pad to k."""
    s, pos = rescore_i8(q_i8, corpus, row_scale, valid, sub_max, k, g)
    return fold_qscale(s, pos, qscale, k)


def two_level_topk_i8(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    row_scale: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    g: int = 16,
    block_scales: bool = False,
    producer: str = "stream",
    tile_n: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized two-level top-k (cosine/ip): f32 queries (B, d), int8
    corpus (N, d) of pre-normalized quantized rows, per-row scales (N,).
    Exact under the quantized metric; scores in the cosine range.

    ``block_scales=True`` asserts every g-row sub-tile shares ONE scale
    (``DeviceFlatIndex``'s int8 storage) and folds the scale in after the
    raw sub-tile max; callers with per-row scales (``quantize_rows``)
    leave it False. ``producer`` picks pass 1 ("stream_piped" needs block
    scales); ``tile_n`` is the "scan" producer's row tile."""
    if producer not in PRODUCERS:
        raise ValueError(f"unknown producer {producer!r}; one of {PRODUCERS}")
    q_i8, qscale = quantize_queries(queries)
    sub = produce(producer, q_i8, corpus, valid, g, tile_n, scale=row_scale,
                  block_scales=block_scales)
    return select_rescore_i8(q_i8, qscale, corpus, row_scale, valid, sub, k, g)
