"""The 768×12 sentence encoder, plain float32.

Pre-LN blocks (LayerNorm eps 1e-6, fused qkv, softmax attention over the
sequence's own tokens, tanh-GELU MLP), a final LayerNorm, the mean over
the tokens and an L2 normalization: the served encoder's design, which
departs from e5-base-v2 (post-LN, erf-GELU, token types) as the
configuration's ``assumed`` says. Each sequence runs at its own length,
so there is no padding and no mask. Weights are a dict with the served
module's parameter names (``trunk.blocks.<i>.qkv.weight``, ...).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from bench_torch.reference import f32_mm

LN_EPS = 1e-6


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), LN_EPS)


def _dense(x, w, b, mm):
    return mm(x, w.t()) + b.float()


def encode_same_length(weights: Dict[str, torch.Tensor], ids: torch.Tensor, cfg: dict,
                       mm=f32_mm) -> torch.Tensor:
    """(B, L) token ids, all of length L → (B, dim) unit f32 vectors."""
    d, heads, depth = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_hidden_layers"]
    hd = d // heads
    b, length = ids.shape
    pos = torch.arange(length, device=ids.device)
    x = weights["trunk.tok_embed.weight"].float()[ids] + weights["trunk.pos_embed.weight"].float()[pos]
    for i in range(depth):
        p = f"trunk.blocks.{i}."
        h = _ln(x, weights[p + "ln_attn.weight"], weights[p + "ln_attn.bias"])
        qkv = _dense(h, weights[p + "qkv.weight"], weights[p + "qkv.bias"], mm)
        q, k, v = (t.reshape(b, length, heads, hd).transpose(1, 2) for t in qkv.split(d, -1))
        probs = torch.softmax(mm(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        ctx = mm(probs, v).transpose(1, 2).reshape(b, length, d)
        x = x + _dense(ctx, weights[p + "attn_out.weight"], weights[p + "attn_out.bias"], mm)
        h = _ln(x, weights[p + "ln_mlp.weight"], weights[p + "ln_mlp.bias"])
        h = F.gelu(_dense(h, weights[p + "mlp_up.weight"], weights[p + "mlp_up.bias"], mm),
                   approximate="tanh")
        x = x + _dense(h, weights[p + "mlp_down.weight"], weights[p + "mlp_down.bias"], mm)
    x = _ln(x, weights["trunk.ln_final.weight"], weights["trunk.ln_final.bias"])
    pooled = x.mean(dim=1)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-12)


@torch.no_grad()
def encode(weights, token_lists: Sequence[List[int]], cfg: dict, device,
           mm=f32_mm, batch: int = 256) -> torch.Tensor:
    """Unit vectors (n, dim) of token sequences of any lengths, grouped by
    length so that each group runs unpadded."""
    out = torch.empty((len(token_lists), cfg["hidden_size"]), device=device)
    by_len: Dict[int, List[int]] = {}
    for i, t in enumerate(token_lists):
        by_len.setdefault(len(t), []).append(i)
    for idx in by_len.values():
        for lo in range(0, len(idx), batch):
            part = idx[lo:lo + batch]
            ids = torch.tensor([token_lists[i] for i in part], device=device)
            out[torch.tensor(part, device=device)] = encode_same_length(weights, ids, cfg, mm)
    return out
