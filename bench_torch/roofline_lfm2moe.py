"""Operations and bytes of the LFM2-MoE reranker's work (LFM2-8B-A1B).

Counts follow from the pairs' real token lengths and the configuration,
never from the kernels' choices (tiles, padding, the sentinel rows of
padding tokens). ``cfg`` is the configuration file's dict of model keys
(LFM2-8B-A1B's ``config.json`` names). Matmul FLOPs only, counted with the
active parameters: per token, the conv layers' in/out projections, the
attention layers' q/k/v/out projections, the dense SwiGLUs, and in each
MoE layer the router and ``num_experts_per_tok`` expert SwiGLUs; per pair,
causal attention at its length and the vocabulary head at its last token.
"""

from __future__ import annotations

from bench_torch import roofline


def _dims(cfg: dict) -> tuple:
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    return h, nh, cfg["num_key_value_heads"], h // nh


def counts_by_kind(cfg: dict) -> dict:
    """Layers of each kind: conv, attention, dense FFN, MoE FFN."""
    n = cfg["num_hidden_layers"]
    attn = sum(1 for t in cfg["layer_types"] if t == "full_attention")
    dense = min(cfg["num_dense_layers"], n)
    return {"conv": n - attn, "attention": attn, "dense": dense, "moe": n - dense}


def expert_flops_per_assignment(cfg: dict) -> float:
    """One token's pass through one expert: gate and up (H → 2I), down (I → H)."""
    return 6.0 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def token_flops(cfg: dict) -> dict:
    """Matmul FLOPs of one token through the whole stack, by part."""
    h, nh, nkv, hd = _dims(cfg)
    n = counts_by_kind(cfg)
    return {
        "conv": n["conv"] * (2.0 * h * 3 * h + 2.0 * h * h),
        "attention": n["attention"] * (2.0 * h * (nh + 2 * nkv) * hd + 2.0 * nh * hd * h),
        "dense": n["dense"] * 6.0 * h * cfg["intermediate_size"],
        "router": n["moe"] * 2.0 * h * cfg["num_experts"],
        "experts": n["moe"] * cfg["num_experts_per_tok"] * expert_flops_per_assignment(cfg),
    }


def pair_flops(cfg: dict, length: int) -> float:
    """A pair of ``length`` real tokens: every token through the stack,
    causal attention in the attention layers, the head at the last token."""
    h, nh, _, hd = _dims(cfg)
    attn = counts_by_kind(cfg)["attention"] * roofline.causal_attention_flops(length, nh, hd)
    return length * sum(token_flops(cfg).values()) + attn + 2.0 * h * cfg["vocab_size"]


def attention_bound_s(cfg: dict, length: int) -> float:
    """The attention layers' rope/qk-norm and flash calls for one pair."""
    _, nh, nkv, hd = _dims(cfg)
    return counts_by_kind(cfg)["attention"] * roofline.attention_layer_bound_s(
        length, nh, nkv, hd)


def expert_weight_bytes(cfg: dict, dtype_bytes: int = 2) -> float:
    """One MoE layer's expert weights, each read once."""
    return (cfg["num_experts"] * 3.0 * cfg["hidden_size"] * cfg["moe_intermediate_size"]
            * dtype_bytes)


def moe_bound_s(cfg: dict, tokens: int, layer_calls: int) -> float:
    """The expert FFN over ``tokens`` live tokens in ``layer_calls`` MoE
    layer calls: the assignments' operations at the bf16 peak, or each
    call's expert weights read once, the larger."""
    flops = (tokens * counts_by_kind(cfg)["moe"] * cfg["num_experts_per_tok"]
             * expert_flops_per_assignment(cfg))
    return roofline.bound_s(flops, layer_calls * expert_weight_bytes(cfg))


def short_conv_bound_s(cfg: dict, tokens: int, dtype_bytes: int = 2) -> float:
    """The conv layers' short convolutions over ``tokens`` live tokens:
    reading B, C and x and writing y once each, in bf16."""
    per_token = 4.0 * cfg["hidden_size"] * dtype_bytes
    return roofline.bound_s(0.0, tokens * counts_by_kind(cfg)["conv"] * per_token)
