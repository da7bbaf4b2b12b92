"""Seeded weights for the served models and their references.

All of a model's values come from one ``torch.randn`` on the card (a few
large calls, not one per leaf), split into tensors named as the served
modules name their parameters. Matrices take N(0, std) with std
1/sqrt(fan_in) for the encoder and 0.02 for Qwen3 (the reranker bench's
recipe); biases N(0, 0.02); norm scales 1 + N(0, 0.02), so that every
parameter shapes the output and a path that skips one shows.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from bench_torch.data import subseed


def _fill(specs: List[Tuple[str, tuple, str, float]], seed: int, device,
          dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """specs: (name, shape, kind, std) with kind "normal", "bias" or "scale"."""
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    gen = torch.Generator(device=device).manual_seed(subseed(seed, 7))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind, std in specs:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if kind == "scale":
            t = 1.0 + std * t
        else:
            t = std * t
        out[name] = t.to(dtype)
    return out


def encoder_weights(cfg: dict, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    d, depth, mlp = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["intermediate_size"]
    s = [("trunk.tok_embed.weight", (cfg["vocab_size"], d), "normal", 1 / math.sqrt(d)),
         ("trunk.pos_embed.weight", (cfg["max_position_embeddings"], d), "normal",
          1 / math.sqrt(d))]
    for i in range(depth):
        p = f"trunk.blocks.{i}."
        s += [(p + "ln_attn.weight", (d,), "scale", 0.02), (p + "ln_attn.bias", (d,), "bias", 0.02),
              (p + "qkv.weight", (3 * d, d), "normal", 1 / math.sqrt(d)),
              (p + "qkv.bias", (3 * d,), "bias", 0.02),
              (p + "attn_out.weight", (d, d), "normal", 1 / math.sqrt(d)),
              (p + "attn_out.bias", (d,), "bias", 0.02),
              (p + "ln_mlp.weight", (d,), "scale", 0.02), (p + "ln_mlp.bias", (d,), "bias", 0.02),
              (p + "mlp_up.weight", (mlp, d), "normal", 1 / math.sqrt(d)),
              (p + "mlp_up.bias", (mlp,), "bias", 0.02),
              (p + "mlp_down.weight", (d, mlp), "normal", 1 / math.sqrt(mlp)),
              (p + "mlp_down.bias", (d,), "bias", 0.02)]
    s += [("trunk.ln_final.weight", (d,), "scale", 0.02),
          ("trunk.ln_final.bias", (d,), "bias", 0.02)]
    return _fill(s, subseed(seed, 1), device, dtype)


def qwen3_weights(cfg: dict, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    h, nh, nkv, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                      cfg["num_key_value_heads"], cfg["head_dim"])
    inter = cfg["intermediate_size"]
    s = [("embed_tokens.weight", (cfg["vocab_size"], h), "normal", 0.02)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        s += [(p + "input_layernorm.weight", (h,), "scale", 0.02),
              (p + "self_attn.qkv_proj.weight", ((nh + 2 * nkv) * hd, h), "normal", 0.02),
              (p + "self_attn.o_proj.weight", (h, nh * hd), "normal", 0.02),
              (p + "self_attn.q_norm.weight", (hd,), "scale", 0.02),
              (p + "self_attn.k_norm.weight", (hd,), "scale", 0.02),
              (p + "post_attention_layernorm.weight", (h,), "scale", 0.02),
              (p + "gateup_proj.weight", (2 * inter, h), "normal", 0.02),
              (p + "down_proj.weight", (h, inter), "normal", 0.02)]
    s += [("norm.weight", (h,), "scale", 0.02)]
    if not cfg["tie_word_embeddings"]:
        s += [("lm_head.weight", (cfg["vocab_size"], h), "normal", 0.02)]
    return _fill(s, subseed(seed, 2), device, dtype)
