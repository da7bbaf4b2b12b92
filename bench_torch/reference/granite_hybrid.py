"""Granite 4.0-H causal LM (granite-4.0-h-small), plain float32, read out as
the reranker's yes/no logit gap.

Written from the published equations (HF transformers' ``granitemoehybrid``
modeling file and config), independent of the served code and of its
kernels' algorithms: the state-space scan runs as the recurrence itself,
one token at a time, not in chunks.

- the embeddings times ``embedding_multiplier``;
- every layer: ``x += m · mixer(rms(x))``, then
  ``x += m · (moe(rms(x)) + shared(rms(x)))``, with ``m`` the
  ``residual_multiplier`` and ``rms(x) = w · x / sqrt(mean(x²) + eps)``;
- Mamba layers: ``[z | xBC | dt] = in_proj(h)``; ``xBC`` through a
  depthwise causal conv of ``mamba_d_conv`` taps (zero before the
  sequence) plus its bias, then SiLU, split into x (heads × d_head), B and
  C (``mamba_d_state`` each, one group); ``dt = softplus(dt + dt_bias)``,
  ``A = −exp(A_log)``; per head from a zero state,
  ``state_t = exp(dt_t · A) · state_{t−1} + dt_t · x_t ⊗ B_t`` and
  ``y_t = state_t · C_t + D · x_t``; then ``w · rms(y · silu(z))`` over all
  d_inner channels, and ``out_proj``;
- attention layers (no position embedding): q, k, v projections, causal
  softmax attention at scale ``attention_multiplier`` over KV heads
  shared by heads/kv_heads query heads, ``o_proj``;
- the sparse block: router logits over every expert, the
  ``num_experts_per_tok`` largest, weights the softmax over those; output
  ``Σ w_e · SwiGLU_e(h)`` over the chosen experts this card holds
  (``held_experts``, ``(lo, hi)``; the rest of the sum comes from the
  cards that hold them and is left out here as in the program); the
  shared expert ``SwiGLU(h)`` beside it;
- the final norm and the tied (or separate) vocabulary head at the last
  token, divided by ``logits_scaling``.

Departures from HF, none of which changes the function: sequences are
right-padded and each read at its own last token, so under causal
attention, a causal conv and a forward recurrence no real token sees a
pad (HF masks left padding instead); pads are routed like tokens and read
by nobody; only the needed rows of the vocabulary head are computed.
Weights are a dict with the served module's parameter names
(``layers.<i>.mamba.in_proj.weight``, ...; the experts cut to the held
range), in any dtype: each layer's are cast to f32 when that layer runs,
for every sequence at once, so that on the card only one layer is held in
f32 beside the stored weights. Every matmul goes through ``mm`` (the fp8
control passes ``fp8_mm``); the recurrence's elementwise steps stay f32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from bench_torch.reference import exact_f32, f32_mm


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _swiglu(h, gateup, down, mm):
    inter = down.shape[-1]
    gu = mm(h, gateup.t())
    return mm(F.silu(gu[..., :inter]) * gu[..., inter:], down.t())


def ssd_sequential(x, b, c, step, a_log, d, mm=f32_mm):
    """The scan as its recurrence: ``x`` (n, L, heads, P), ``b``, ``c``
    (n, L, N), ``step`` (n, L, heads) the time steps after the softplus,
    ``a_log``, ``d`` (heads,). Returns y (n, L, heads, P); every sequence
    starts at its column 0 from a zero state."""
    n, length, heads, p = x.shape
    a = -torch.exp(a_log.float())
    state = torch.zeros(n * heads, p, b.shape[-1], device=x.device)
    ys = torch.empty_like(x)
    for t in range(length):
        decay = torch.exp(step[:, t] * a).reshape(n * heads, 1, 1)
        dx = (step[:, t, :, None] * x[:, t]).reshape(n * heads, p, 1)
        bt = b[:, t, None, None, :].expand(n, heads, 1, b.shape[-1]).reshape(n * heads, 1, -1)
        state.mul_(decay).baddbmm_(dx, bt)
        ct = c[:, t, None, :, None].expand(n, heads, -1, 1).reshape(n * heads, -1, 1)
        ys[:, t] = mm(state, ct).reshape(n, heads, p) + d.float()[:, None] * x[:, t]
    return ys


def ssd_packed(xbc, dt, a_log, dt_bias, d, seg, heads, p, n, state_dtype=torch.float32):
    """The recurrence over packed rows, for holding a scan op to: ``xbc``
    (R, L, heads·p + 2n) the convolved ``[x | B | C]``, ``dt`` (R, L,
    heads) the raw time steps, ``seg`` (R, L) segment ids, −1 on padding.
    The state restarts at each segment start, and a padding token's y is
    zero. ``state_dtype`` rounds the state at every token (torch.bfloat16:
    a scan that holds its state in bf16, a control). Returns y (R, L,
    heads·p) in f32."""
    r, length, _ = xbc.shape
    v = xbc.float()
    x = v[..., : heads * p].reshape(r, length, heads, p)
    b, c = v[..., heads * p : heads * p + n], v[..., heads * p + n :]
    step = F.softplus(dt.float() + dt_bias.float())
    a = -torch.exp(a_log.float())
    state = torch.zeros(r, heads, p, n, device=xbc.device)
    y = torch.zeros(r, length, heads, p, device=xbc.device)
    for t in range(length):
        start = seg[:, t] != (seg[:, t - 1] if t else -2)
        decay = torch.where(start[:, None], 0.0, torch.exp(step[:, t] * a))
        state = state * decay[..., None, None] + (step[:, t, :, None, None] * x[:, t, :, :, None]
                                                  * b[:, t, None, None, :])
        state = state.to(state_dtype).float()
        out = torch.einsum("rhpn,rn->rhp", state, c[:, t]) + d.float()[:, None] * x[:, t]
        y[:, t] = torch.where((seg[:, t] >= 0)[:, None, None], out, 0.0)
    return y.reshape(r, length, heads * p)


def _mamba(h, lw, p, cfg, mm):
    m = p + "mamba."
    heads, dh, n = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    inner = heads * dh
    conv = inner + 2 * n
    proj = mm(h, lw[m + "in_proj.weight"].t())
    z, xbc, dt = proj[..., :inner], proj[..., inner:inner + conv], proj[..., inner + conv:]
    w = lw[m + "conv1d.weight"]
    taps, length = w.shape[1], xbc.shape[1]
    acc = torch.zeros_like(xbc)
    for j in range(taps):
        s = taps - 1 - j
        if s < length:
            acc[:, s:] += xbc[:, : length - s] * w[:, j]
    if m + "conv1d.bias" in lw:
        acc += lw[m + "conv1d.bias"]
    xbc = F.silu(acc)
    bsz = xbc.shape[0]
    x = xbc[..., :inner].reshape(bsz, length, heads, dh)
    step = F.softplus(dt + lw[m + "dt_bias"])
    y = ssd_sequential(x, xbc[..., inner:inner + n], xbc[..., inner + n:], step,
                       lw[m + "A_log"], lw[m + "D"], mm).reshape(bsz, length, inner)
    g = _rms(y * F.silu(z), lw[m + "norm.weight"], cfg["rms_norm_eps"])
    return mm(g, lw[m + "out_proj.weight"].t())


def _attention(h, lw, p, cfg, mm):
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // nh
    b, length, _ = h.shape
    qkv = mm(h, lw[p + "self_attn.qkv_proj.weight"].t())
    q = qkv[..., : nh * hd].reshape(b, length, nh, hd).transpose(1, 2)
    k = qkv[..., nh * hd:(nh + nkv) * hd].reshape(b, length, nkv, hd).transpose(1, 2)
    v = qkv[..., (nh + nkv) * hd:].reshape(b, length, nkv, hd).transpose(1, 2)
    k = k.repeat_interleave(nh // nkv, dim=1)
    v = v.repeat_interleave(nh // nkv, dim=1)
    s = mm(q, k.transpose(-1, -2)) * cfg["attention_multiplier"]
    causal = torch.ones(length, length, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = mm(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(b, length, nh * hd)
    return mm(o, lw[p + "self_attn.o_proj.weight"].t())


def feed_forward(h, lw, p, cfg, mm=f32_mm):
    """A layer's sparse block over the held experts plus its shared expert."""
    f = p + "block_sparse_moe."
    flat = h.reshape(-1, h.shape[-1])
    router = lw[f + "router.weight"]
    lo, hi = cfg.get("held_experts") or (0, router.shape[0])
    top, chosen = torch.topk(mm(flat, router.t()), cfg["num_experts_per_tok"], dim=-1)
    w = torch.softmax(top, dim=-1)
    out = torch.zeros_like(flat)
    for e in range(lo, hi):
        tok, slot = torch.nonzero(chosen == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _swiglu(flat[tok], lw[f + "gateup_proj"][e - lo], lw[f + "down_proj"][e - lo], mm)
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    shared = _swiglu(flat, lw[p + "shared_mlp.gateup_proj.weight"],
                     lw[p + "shared_mlp.down_proj.weight"], mm)
    return (out + shared).view_as(h)


def _layer(x, lw, i, cfg, mm):
    p, eps, m = f"layers.{i}.", cfg["rms_norm_eps"], cfg["residual_multiplier"]
    h = _rms(x, lw[p + "input_layernorm.weight"], eps)
    mix = _attention if cfg["layer_types"][i] == "attention" else _mamba
    x = x + m * mix(h, lw, p, cfg, mm)
    h = _rms(x, lw[p + "post_attention_layernorm.weight"], eps)
    return x + m * feed_forward(h, lw, p, cfg, mm)


@torch.no_grad()
def last_logits(weights: Dict[str, torch.Tensor], token_lists: Sequence[List[int]], cfg: dict,
                device, rows: Optional[Sequence[int]] = None, mm=f32_mm,
                batch: int = 64) -> torch.Tensor:
    """(n, V) — or (n, len(rows)), the vocabulary ``rows`` only — logits
    at each token sequence's last token, in right-padded batches of
    similar lengths, layer by layer over all batches. TF32 is switched off
    first, so that an f32 matmul on the card is f32."""
    exact_f32()
    order = sorted(range(len(token_lists)), key=lambda i: len(token_lists[i]))
    emb = weights["embed_tokens.weight"]
    parts, xs = [], []
    for lo in range(0, len(order), batch):
        part = order[lo:lo + batch]
        length = max(len(token_lists[i]) for i in part)
        ids = torch.zeros((len(part), length), dtype=torch.long, device=device)
        for r, i in enumerate(part):
            ids[r, : len(token_lists[i])] = torch.tensor(token_lists[i], device=device)
        parts.append(part)
        xs.append(emb[ids].float() * cfg["embedding_multiplier"])
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        lw = {k: v.float() for k, v in weights.items() if k.startswith(p)}
        xs = [_layer(x, lw, i, cfg, mm) for x in xs]
        del lw
    head = weights.get("lm_head.weight", emb)
    head = (head if rows is None else head[torch.tensor(list(rows), device=device)]).float()
    out = torch.empty((len(token_lists), head.shape[0]), device=device)
    for part, x in zip(parts, xs):
        last = torch.tensor([len(token_lists[i]) - 1 for i in part], device=device)
        hl = _rms(x[torch.arange(len(part), device=device), last], weights["norm.weight"],
                  cfg["rms_norm_eps"])
        out[torch.tensor(part, device=device)] = mm(hl, head.t()) / cfg["logits_scaling"]
    return out


def yes_no_gap(weights, token_lists: Sequence[List[int]], cfg: dict, yes: int, no: int,
               device, mm=f32_mm) -> torch.Tensor:
    """(n,) logit(yes) − logit(no) of each token sequence."""
    logits = last_logits(weights, token_lists, cfg, device, rows=[yes, no], mm=mm)
    return logits[:, 0] - logits[:, 1]
