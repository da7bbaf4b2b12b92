"""Sparse experts: the router, the permutation of the tokens by expert, the
grouped SwiGLU expert GEMMs and the weighted sum back, all on the device
with no host sync.

Replaces no TPU kernel: the JAX package has no sparse-expert model. It was
added for ``models/lfm2_moe.py`` (LFM2-8B-A1B's MoE blocks, ``lfm2_moe``
in HF transformers) and serves ``models/granite_hybrid.py`` too (Granite
4.0-H's, ``granitemoehybrid``). :func:`moe_route` computes, for each live
token, with ``scoring="sigmoid"`` (LFM2)

    s = sigmoid(x · Wr)                  (f32)
    chosen = top_k(s + expert_bias)      (the bias steers the choice only)
    w = s[chosen] / (sum s[chosen] + 1e-6) · routed_scaling_factor

or with ``scoring="softmax"`` (Granite's ``TopKGating``)

    logits = x · Wr                      (f32)
    chosen = top_k(logits)
    w = softmax(logits[chosen])          (over the k chosen only)

and sorts the token's k assignments by expert (``Routing``). A layer may
hold only some of the experts it routes over (``held``, the range of
experts this card holds under expert parallelism): the router still
routes over all of them, and the assignments to experts it does not hold
sort past the held ones with the padding tokens' and are never computed,
so the layer gives the held experts' part of the result. The router
runs in f32 where HF runs it in the model's dtype: a bf16 router rounds
scores that differ by less than its step to one value and then chooses by
position, so it would part from the f32 reference wherever two scores lie
within ~0.4% of each other; in f32 the program and the reference choose
apart only where the scores truly tie. Padding tokens (``live`` False) are
not routed: they sort past the last expert, no GEMM reads them, and their
output is zero.

:func:`moe_experts` runs ``y = sum_k w_k · down_e(silu(gate_e(x)) · up_e(x))``
over the permuted assignment rows. On the card: the token rows gathered
in expert order, the gate/up projection as one ``torch._grouped_mm`` (a
grouped GEMM over the experts' row ranges, read from the device offsets:
one call a projection a layer, no loop over experts, no host sync), one
Triton elementwise pass ``h = silu(g) · u · w`` (the routing weight folded
in before the down projection, which is linear, so each product rounds to
bf16 once), the down projection as a second ``torch._grouped_mm``, then
the sum over a token's k rows as a gather and a sum in which each
assignment past the held experts' rows (never written) reads a zeroed row.
At the served shapes
(~1,790 rows an expert a layer) the GEMMs are bound by the tensor cores:
6·H·I operations an assignment at 989 TFLOP/s, against the expert weights
read once a forward at 3.35 TB/s. On the CPU :func:`moe_experts_plain`
loops over the experts with the same rounding points.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rag_arc_tpu_torch.ops._build import count_launch

# kernel launches since the count was last set to 0 (one a call: the SwiGLU
# pass); only the CUDA branch adds
launches = 0

SCORINGS = ("sigmoid", "softmax")

BLOCK_R = 8
BLOCK_C = 256


@dataclasses.dataclass
class Routing:
    """A layer's assignments sorted by expert. ``A`` = tokens × k rows; the
    rows past ``offsets[E]`` (E the held experts) belong to experts not held
    or to padding tokens and are not computed."""

    token: torch.Tensor    # (A,) int32: the token of each sorted row
    weight: torch.Tensor   # (A,) f32: its routing weight
    slot: torch.Tensor     # (tokens · k,) int64: the sorted row of each (token, choice)
    offsets: torch.Tensor  # (E + 1,) int32: held expert e's rows are [offsets[e], offsets[e + 1])
    top_k: int


def moe_route(
    x: torch.Tensor,
    gate_weight: torch.Tensor,
    expert_bias: Optional[torch.Tensor],
    top_k: int,
    *,
    scoring: str = "sigmoid",
    norm_topk_prob: bool = True,
    routed_scaling_factor: float = 1.0,
    held: Optional[Tuple[int, int]] = None,
    live: Optional[torch.Tensor] = None,
    counts: Optional[torch.Tensor] = None,
) -> Routing:
    """``x`` (T, H), ``gate_weight`` (E, H) over every expert routed to,
    ``expert_bias`` (E,) or None (sigmoid scoring only), ``held`` the range
    ``(lo, hi)`` of experts this layer computes (None: all), ``live`` (T,)
    bool or None. ``counts``, a (3,) int64 device tensor, gains this layer's
    routed assignments, those on held experts, and the busiest held
    expert's rows (read back with the caller's results, no sync here)."""
    if scoring not in SCORINGS:
        raise ValueError(f"scoring must be one of {SCORINGS}, got {scoring!r}")
    n_exp = gate_weight.shape[0]
    lo, hi = (0, n_exp) if held is None else held
    if not 0 <= lo < hi <= n_exp:
        raise ValueError(f"held must be a range within [0, {n_exp}), got {held}")
    n_held = hi - lo
    logits = F.linear(x.float(), gate_weight.float())
    if scoring == "softmax":
        top, chosen = torch.topk(logits, top_k, dim=-1)
        weight = torch.softmax(top, dim=-1)
    else:
        scores = torch.sigmoid(logits)
        pick = scores if expert_bias is None else scores + expert_bias.float()
        chosen = torch.topk(pick, top_k, dim=-1).indices
        weight = scores.gather(1, chosen)
        if norm_topk_prob:
            weight = weight / (weight.sum(dim=-1, keepdim=True) + 1e-6)
        weight = weight * routed_scaling_factor
    # sort keys: a held expert's own index from 0, then n_held for a live
    # token's expert that is not held, n_held + 1 for a padding token's
    expert = chosen.to(torch.int32)
    if held is not None:
        expert = expert - lo
        expert = torch.where((expert >= 0) & (expert < n_held), expert, n_held)
    if live is not None:
        expert = torch.where(live[:, None], expert, n_held + 1)
    sorted_expert, order = torch.sort(expert.flatten(), stable=True)
    ends = torch.searchsorted(
        sorted_expert, torch.arange(n_held + 2, dtype=torch.int32, device=x.device),
        out_int32=True)
    offsets = ends[: n_held + 1]
    slot = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=x.device))
    if counts is not None:
        rows = offsets[1:] - offsets[:-1]
        counts += torch.stack([ends[-1].long(), ends[-2].long(), rows.max().long()])
    return Routing(token=torch.div(order, top_k, rounding_mode="floor").to(torch.int32),
                   weight=weight.flatten().index_select(0, order), slot=slot,
                   offsets=offsets, top_k=top_k)


def _combine(rows: torch.Tensor, routing: Routing) -> torch.Tensor:
    """The sum of each token's k weighted rows (f32 sum, one rounding), each
    assignment past the held experts' rows (an expert not held, or a padding
    token's) taken as zero, so a padding token's output is zero. Those rows
    are never written on the card: every such assignment reads the last row
    instead, which is one of them and is zeroed first, so no pass over the
    gathered rows is needed to mask them (no host sync either)."""
    k, h = routing.top_k, rows.shape[-1]
    if rows.shape[0] == 0:
        return rows.new_zeros((routing.slot.numel() // k, h))
    end, last = routing.offsets[-1], rows.shape[0] - 1
    rows[last] = torch.where(end <= last, 0, rows[last])
    src = torch.where(routing.slot < end, routing.slot, last)
    return rows.index_select(0, src).view(-1, k, h).sum(dim=1)


def moe_experts_plain(x: torch.Tensor, routing: Routing, gateup: torch.Tensor,
                      down: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`moe_experts`: a loop over the
    experts, f32 products, the gate/up rows, ``silu(g) · u · w`` and the
    down rows each rounded to x's dtype as the card rounds them."""
    inter = down.shape[-1]
    offs = routing.offsets.tolist()
    rows = torch.zeros((routing.token.numel(), x.shape[-1]), dtype=x.dtype, device=x.device)
    for e in range(gateup.shape[0]):
        lo, hi = offs[e], offs[e + 1]
        if hi == lo:
            continue
        xe = x.index_select(0, routing.token[lo:hi].long()).float()
        gu = (xe @ gateup[e].float().t()).to(x.dtype).float()
        h = (F.silu(gu[:, :inter]) * gu[:, inter:] * routing.weight[lo:hi, None]).to(x.dtype)
        rows[lo:hi] = (h.float() @ down[e].float().t()).to(x.dtype)
    return _combine(rows, routing)


def swiglu_plain(gu: torch.Tensor, weight: torch.Tensor, n_live: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`swiglu`: rows past ``n_live`` are
    zero here (the kernel leaves them unwritten)."""
    inter = gu.shape[1] // 2
    g, u = gu.float().split(inter, dim=1)
    h = (F.silu(g) * u * weight[:, None].float()).to(gu.dtype)
    keep = torch.arange(gu.shape[0], device=gu.device) < n_live.reshape(())
    return h.masked_fill(~keep[:, None], 0)


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit(do_not_specialize=["n_rows"])
    def swiglu_kernel(gu_ptr, w_ptr, live_ptr, h_ptr, n_rows, I: tl.constexpr,
                      BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        c = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        r_ok = r < tl.minimum(n_rows, tl.load(live_ptr))
        m = r_ok[:, None] & (c < I)[None, :]
        src = gu_ptr + r.to(tl.int64)[:, None] * (2 * I) + c[None, :]
        g = tl.load(src, mask=m, other=0.0).to(tl.float32)
        u = tl.load(src + I, mask=m, other=0.0).to(tl.float32)
        w = tl.load(w_ptr + r, mask=r_ok, other=0.0)
        h = g * tl.sigmoid(g) * u * w[:, None]
        dst = h_ptr + r.to(tl.int64)[:, None] * I + c[None, :]
        tl.store(dst, h.to(h_ptr.dtype.element_ty), mask=m)

    return triton, swiglu_kernel


def swiglu(gu: torch.Tensor, weight: torch.Tensor, n_live: torch.Tensor) -> torch.Tensor:
    """``gu`` (A, 2I) bf16, each row's gate then its up product; ``weight``
    (A,) f32; ``n_live`` a one-element int32 device tensor. Returns ``h``
    (A, I) bf16, ``silu(g) · u · w`` computed in f32 and rounded once, for
    the first ``n_live`` rows; the rest are left unwritten (no GEMM reads
    them). One Triton launch on the current stream."""
    n, two_i = gu.shape
    inter = two_i // 2
    h = torch.empty((n, inter), dtype=gu.dtype, device=gu.device)
    if n == 0:
        return h
    triton, kernel = _kernel()
    with torch.cuda.device(gu.device):
        kernel[(triton.cdiv(n, BLOCK_R), triton.cdiv(inter, BLOCK_C))](
            gu, weight, n_live, h, n, I=inter, BLOCK_R=BLOCK_R, BLOCK_C=BLOCK_C, num_warps=4)
    count_launch(__name__)
    return h


def moe_experts(x: torch.Tensor, routing: Routing, gateup: torch.Tensor,
                down: torch.Tensor) -> torch.Tensor:
    """``x`` (T, H); ``gateup`` (E, 2I, H), each held expert's gate rows then
    its up rows; ``down`` (E, H, I). Returns (T, H) in x's dtype: the held
    experts' part of the layer. CPU tensors take :func:`moe_experts_plain`;
    CUDA tensors run the two grouped GEMMs and the SwiGLU pass on the
    current stream or raise."""
    n_exp, two_i, h = gateup.shape
    inter = two_i // 2
    if x.ndim != 2 or x.shape[1] != h or down.shape != (n_exp, h, inter):
        raise ValueError(f"expected x (T, {h}), gateup (E, 2I, {h}) and down (E, {h}, I), got "
                         f"{tuple(x.shape)}, {tuple(gateup.shape)}, {tuple(down.shape)}")
    if routing.offsets.numel() != n_exp + 1:
        raise ValueError(f"the routing holds {routing.offsets.numel() - 1} experts, the "
                         f"weights {n_exp}")
    if x.device.type == "cpu":
        return moe_experts_plain(x, routing, gateup, down)
    if x.device.type != "cuda":
        raise ValueError(f"no moe_experts kernel for device {x.device}")
    if x.dtype != torch.bfloat16 or gateup.dtype != x.dtype or down.dtype != x.dtype:
        raise ValueError(f"moe_experts takes bf16 x and weights, got {x.dtype}, "
                         f"{gateup.dtype}, {down.dtype}")
    if not (x.is_contiguous() and gateup.is_contiguous() and down.is_contiguous()):
        raise ValueError("moe_experts needs contiguous tensors")
    return grouped_experts(x, routing, gateup, down, swiglu)


def grouped_experts(x: torch.Tensor, routing: Routing, gateup: torch.Tensor,
                    down: torch.Tensor, act) -> torch.Tensor:
    """The card's composition of :func:`moe_experts`, with ``act`` the
    SwiGLU pass (:func:`swiglu`, or :func:`swiglu_plain` to run it on the
    CPU). ``torch._grouped_mm`` takes the experts' cumulative row ends
    (``offsets[1:]``) and each weight as (E, K, N), a transposed view."""
    ends = routing.offsets[1:]
    # rows past offsets[E] (experts not held, padding tokens) are gathered
    # but no GEMM computes them
    xs = x.index_select(0, routing.token)
    gu = torch._grouped_mm(xs, gateup.transpose(1, 2), offs=ends)
    hid = act(gu, routing.weight, routing.offsets[-1:])
    rows = torch._grouped_mm(hid, down.transpose(1, 2), offs=ends)
    return _combine(rows, routing)
