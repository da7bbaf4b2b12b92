"""Qwen3 causal LM, plain float32, read out as the reranker's yes/no logit gap.

RMSNorm (eps from the config) before attention and MLP, fused q/k/v
projection, per-head RMSNorm of q and k, rotary embedding (half split,
theta from the config), grouped-query causal softmax attention, SwiGLU
MLP, final RMSNorm, and the tied (or separate) vocabulary head at the
last token. Sequences are right-padded: under causal attention a real
token never sees a pad after it, so no mask is needed, and each row is
read at its own last token. Weights are a dict with the served module's
parameter names (``layers.<i>.self_attn.qkv_proj.weight``, ...).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

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


def yes_no_gap_padded(weights: Dict[str, torch.Tensor], ids: torch.Tensor,
                      last: torch.Tensor, cfg: dict, yes: int, no: int,
                      mm=f32_mm) -> torch.Tensor:
    """(B, L) right-padded ids, (B,) index of each row's last token →
    (B,) logit(yes) - logit(no) at that token."""
    h, nh, nkv, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                      cfg["num_key_value_heads"], cfg["head_dim"])
    eps, theta, inter = cfg["rms_norm_eps"], cfg["rope_theta"], cfg["intermediate_size"]
    b, length = ids.shape
    x = weights["embed_tokens.weight"].float()[ids]
    causal = torch.ones(length, length, dtype=torch.bool, device=ids.device).tril()
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        a = _rms(x, weights[p + "input_layernorm.weight"], eps)
        qkv = mm(a, weights[p + "self_attn.qkv_proj.weight"].t())
        q = qkv[..., : nh * hd].reshape(b, length, nh, hd)
        k = qkv[..., nh * hd:(nh + nkv) * hd].reshape(b, length, nkv, hd)
        v = qkv[..., (nh + nkv) * hd:].reshape(b, length, nkv, hd).transpose(1, 2)
        q = _rope(_rms(q, weights[p + "self_attn.q_norm.weight"], eps).transpose(1, 2), theta)
        k = _rope(_rms(k, weights[p + "self_attn.k_norm.weight"], eps).transpose(1, 2), theta)
        k = k.repeat_interleave(nh // nkv, dim=1)
        v = v.repeat_interleave(nh // nkv, dim=1)
        s = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        s = s.masked_fill(~causal, float("-inf"))
        o = mm(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(b, length, nh * hd)
        x = x + mm(o, weights[p + "self_attn.o_proj.weight"].t())
        m = _rms(x, weights[p + "post_attention_layernorm.weight"], eps)
        gu = mm(m, weights[p + "gateup_proj.weight"].t())
        x = x + mm(F.silu(gu[..., :inter]) * gu[..., inter:], weights[p + "down_proj.weight"].t())
    hl = _rms(x[torch.arange(b, device=ids.device), last], weights["norm.weight"], eps)
    head = weights.get("lm_head.weight", weights["embed_tokens.weight"])
    rows = head[torch.tensor([yes, no], device=ids.device)]
    logits = mm(hl, rows.t())
    return logits[:, 0] - logits[:, 1]


@torch.no_grad()
def yes_no_gap(weights, token_lists: Sequence[List[int]], cfg: dict, yes: int, no: int,
               device, mm=f32_mm, batch: int = 16) -> torch.Tensor:
    """(n,) yes-minus-no logit of each token sequence, in right-padded
    batches of similar lengths."""
    order = sorted(range(len(token_lists)), key=lambda i: len(token_lists[i]))
    out = torch.empty(len(token_lists), device=device)
    for lo in range(0, len(order), batch):
        part = order[lo:lo + batch]
        length = max(len(token_lists[i]) for i in part)
        ids = torch.zeros((len(part), length), dtype=torch.long, device=device)
        for r, i in enumerate(part):
            ids[r, : len(token_lists[i])] = torch.tensor(token_lists[i], device=device)
        last = torch.tensor([len(token_lists[i]) - 1 for i in part], device=device)
        out[torch.tensor(part, device=device)] = yes_no_gap_padded(
            weights, ids, last, cfg, yes, no, mm)
    return out
