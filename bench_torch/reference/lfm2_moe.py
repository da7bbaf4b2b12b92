"""LFM2-MoE causal LM (LFM2-8B-A1B), plain float32, read out as the
reranker's yes/no logit gap.

Written from the published equations (HF transformers' ``lfm2`` modeling
file for the conv, attention, norm and dense blocks; the ``lfm2_moe``
config keys for the sparse block), independent of the served code:

- every layer: ``x += mixer(rms(x))``, then ``x += ffn(rms(x))``, with
  ``rms(x) = w · x / sqrt(mean(x²) + eps)``;
- conv layers: ``[B | C | x] = in_proj(h)``, ``y = C · conv(B · x)`` with a
  depthwise causal convolution of ``conv_L_cache`` taps
  (``y[t] = Σ_j w[:, j] · (B·x)[t − (K − 1) + j]``, zero before the
  sequence), then ``out_proj``;
- attention layers: q, k, v projections, per-head RMSNorm of q and k,
  RoPE (half split, theta from the config, positions 0..L−1), causal
  softmax attention over KV heads shared by hidden/heads query heads, and
  ``out_proj``;
- the first ``num_dense_layers`` feed-forwards are a SwiGLU
  ``w2(silu(w1 h) · w3 h)``; the rest route each token: ``s =
  sigmoid(h · Wr)``, the ``num_experts_per_tok`` experts of largest ``s +
  expert_bias``, weights ``s`` at those experts over their sum (+1e-6),
  times ``routed_scaling_factor``, output ``Σ w_e · SwiGLU_e(h)``;
- the final ``embedding_norm`` and the tied (or separate) vocabulary head
  at the last token.

Departures from HF, none of which changes the function: the router runs
in f32 (HF runs it in the model's dtype); sequences are right-padded and
each read at its own last token, so under causal attention and a causal
convolution no real token sees a pad (HF masks left padding instead);
pads are routed like tokens and read by nobody; only the needed rows of
the vocabulary head are computed. Weights are a dict with the served
module's parameter names (``layers.<i>.conv.in_proj.weight``, ...), in any
dtype: each layer's are cast to f32 when that layer runs, for every
sequence at once, so that on the card only one layer is held in f32 beside
the stored weights. Every matmul goes through ``mm`` (the fp8 control
passes ``fp8_mm``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from bench_torch.reference import f32_mm


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x, theta):
    """x (B, H, L, D): positions 0..L-1, HF's half-split rotation."""
    d, length = x.shape[-1], x.shape[-2]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float64) / d))
    ang = torch.arange(length, device=x.device, dtype=torch.float64)[:, None] * inv[None]
    cos, sin = ang.cos().float(), ang.sin().float()
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _conv(h, lw, p, cfg, mm):
    hid, k = cfg["hidden_size"], cfg["conv_L_cache"]
    b_, c_, x_ = mm(h, lw[p + "conv.in_proj.weight"].t()).split(hid, dim=-1)
    bx = b_ * x_
    w = lw[p + "conv.weight"]
    length = bx.shape[1]
    acc = torch.zeros_like(bx)
    for j in range(k):
        d = k - 1 - j
        if d < length:
            acc[:, d:] += bx[:, : length - d] * w[:, j]
    return mm(c_ * acc, lw[p + "conv.out_proj.weight"].t())


def _attention(h, lw, p, cfg, mm):
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // nh
    eps = cfg["norm_eps"]
    b, length, _ = h.shape
    qkv = mm(h, lw[p + "self_attn.qkv_proj.weight"].t())
    q = qkv[..., : nh * hd].reshape(b, length, nh, hd)
    k = qkv[..., nh * hd:(nh + nkv) * hd].reshape(b, length, nkv, hd)
    v = qkv[..., (nh + nkv) * hd:].reshape(b, length, nkv, hd).transpose(1, 2)
    q = _rope(_rms(q, lw[p + "self_attn.q_norm.weight"], eps).transpose(1, 2), cfg["rope_theta"])
    k = _rope(_rms(k, lw[p + "self_attn.k_norm.weight"], eps).transpose(1, 2), cfg["rope_theta"])
    k = k.repeat_interleave(nh // nkv, dim=1)
    v = v.repeat_interleave(nh // nkv, dim=1)
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(length, length, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = mm(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(b, length, nh * hd)
    return mm(o, lw[p + "self_attn.o_proj.weight"].t())


def _swiglu(h, gateup, down, mm):
    inter = down.shape[-1]
    gu = mm(h, gateup.t())
    return mm(F.silu(gu[..., :inter]) * gu[..., inter:], down.t())


def _moe(h, lw, p, cfg, mm):
    f = p + "feed_forward."
    flat = h.reshape(-1, h.shape[-1])
    scores = torch.sigmoid(mm(flat, lw[f + "gate.weight"].t()))
    pick = scores + lw[f + "expert_bias"] if cfg["use_expert_bias"] else scores
    chosen = torch.topk(pick, cfg["num_experts_per_tok"], dim=-1).indices
    w = scores.gather(1, chosen)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-6)
    w = w * cfg["routed_scaling_factor"]
    out = torch.zeros_like(flat)
    for e in range(cfg["num_experts"]):
        tok, slot = torch.nonzero(chosen == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _swiglu(flat[tok], lw[f + "gateup_proj"][e], lw[f + "down_proj"][e], mm)
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out.view_as(h)


def _layer(x, lw, i, cfg, mm):
    p, eps = f"layers.{i}.", cfg["norm_eps"]
    h = _rms(x, lw[p + "operator_norm.weight"], eps)
    mix = _attention if cfg["layer_types"][i] == "full_attention" else _conv
    x = x + mix(h, lw, p, cfg, mm)
    h = _rms(x, lw[p + "ffn_norm.weight"], eps)
    if i < cfg["num_dense_layers"]:
        f = p + "feed_forward."
        return x + _swiglu(h, lw[f + "gateup_proj.weight"], lw[f + "down_proj.weight"], mm)
    return x + _moe(h, lw, p, cfg, mm)


@torch.no_grad()
def last_logits(weights: Dict[str, torch.Tensor], token_lists: Sequence[List[int]], cfg: dict,
                device, rows: Optional[Sequence[int]] = None, mm=f32_mm,
                batch: int = 32) -> torch.Tensor:
    """(n, V) — or (n, len(rows)), the vocabulary ``rows`` only — logits
    at each token sequence's last token, in right-padded batches of
    similar lengths, layer by layer over all batches."""
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
        xs.append(emb[ids].float())
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
        hl = _rms(x[torch.arange(len(part), device=device), last],
                  weights["embedding_norm.weight"], cfg["norm_eps"])
        out[torch.tensor(part, device=device)] = mm(hl, head.t())
    return out


def yes_no_gap(weights, token_lists: Sequence[List[int]], cfg: dict, yes: int, no: int,
               device, mm=f32_mm) -> torch.Tensor:
    """(n,) logit(yes) − logit(no) of each token sequence."""
    logits = last_logits(weights, token_lists, cfg, device, rows=[yes, no], mm=mm)
    return logits[:, 0] - logits[:, 1]
