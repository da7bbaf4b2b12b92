"""Operations and bytes of the Granite 4.0-H reranker's work
(granite-4.0-h-small, this card's share of its experts).

Counts follow from the pairs' real token lengths, the configuration and
the routing counts the program reads back (``moe_held``), never from the
kernels' choices (tiles, the scan's chunks, padding, the sorted rows of
experts not held). ``cfg`` is the system's ``rr_cfg``: the configuration
file's model keys (granite-4.0-h-small's ``config.json`` names) with
``num_local_experts`` the experts the router routes over and
``held_experts`` the range held here.

Matmul FLOPs with the parameters active on this card, for ``step_mfu``:
per token, the Mamba layers' in/out projections, the attention layers'
q/k/v/out projections, every layer's router, shared expert and, of its
``num_experts_per_tok`` routed experts, the share held here (k · held /
experts, the expectation under the router); per pair, causal attention at
its length and the vocabulary head at its last token. The scan's own
~5·P·N FLOPs a head and token are counted in its roofline only.
"""

from __future__ import annotations

from bench_torch import roofline


def _dims(cfg: dict) -> tuple:
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    return h, nh, cfg["num_key_value_heads"], h // nh


def counts_by_kind(cfg: dict) -> dict:
    """Layers of each mixer; every layer has the sparse block and the shared expert."""
    n = cfg["num_hidden_layers"]
    attn = sum(1 for t in cfg["layer_types"] if t == "attention")
    return {"mamba": n - attn, "attention": attn, "moe": n}


def mamba_widths(cfg: dict) -> dict:
    heads, n = cfg["mamba_n_heads"], cfg["mamba_d_state"]
    inner = heads * cfg["mamba_d_head"]
    conv = inner + 2 * cfg["mamba_n_groups"] * n
    return {"heads": heads, "head_dim": cfg["mamba_d_head"], "state": n, "inner": inner,
            "conv": conv, "in_proj": inner + conv + heads}


def held_experts(cfg: dict) -> int:
    lo, hi = cfg["held_experts"]
    return hi - lo


def expert_flops_per_assignment(cfg: dict) -> float:
    """One token's pass through one expert: gate and up (H → 2I), down (I → H)."""
    return 6.0 * cfg["hidden_size"] * cfg["intermediate_size"]


def token_flops(cfg: dict) -> dict:
    """Matmul FLOPs of one token through the whole stack on this card, by part."""
    h, nh, nkv, hd = _dims(cfg)
    n = counts_by_kind(cfg)
    w = mamba_widths(cfg)
    share = cfg["num_experts_per_tok"] * held_experts(cfg) / cfg["num_local_experts"]
    return {
        "mamba": n["mamba"] * (2.0 * h * w["in_proj"] + 2.0 * w["inner"] * h),
        "attention": n["attention"] * (2.0 * h * (nh + 2 * nkv) * hd + 2.0 * nh * hd * h),
        "router": n["moe"] * 2.0 * h * cfg["num_local_experts"],
        "shared": n["moe"] * 6.0 * h * cfg["shared_intermediate_size"],
        "experts": n["moe"] * share * expert_flops_per_assignment(cfg),
    }


def pair_flops(cfg: dict, length: int) -> float:
    """A pair of ``length`` real tokens: every token through the stack,
    causal attention in the attention layers, the head at the last token."""
    h, nh, _, hd = _dims(cfg)
    attn = counts_by_kind(cfg)["attention"] * roofline.causal_attention_flops(length, nh, hd)
    return length * sum(token_flops(cfg).values()) + attn + 2.0 * h * cfg["vocab_size"]


def attention_bound_s(cfg: dict, length: int) -> float:
    """The attention layers' flash calls for one pair: causal QKᵀ and PV at
    the bf16 peak, or q, k, v read and the output written once."""
    _, nh, nkv, hd = _dims(cfg)
    elems = (2 * nh + 2 * nkv) * hd * length
    one = roofline.bound_s(roofline.causal_attention_flops(length, nh, hd), 2.0 * elems)
    return counts_by_kind(cfg)["attention"] * one


def ssd_bound_s(cfg: dict, tokens: int, dtype_bytes: int = 2) -> float:
    """The Mamba layers' scans over ``tokens`` live tokens: the recurrence's
    5·P·N FLOPs a head (the decay, the outer product and its add, the
    readout) at the bf16 peak of the tensor cores that compute them (the
    kernel's products take bf16 operands), or x, B, C and dt read and y
    written once, the larger."""
    w = mamba_widths(cfg)
    layers = counts_by_kind(cfg)["mamba"]
    flops = 5.0 * w["heads"] * w["head_dim"] * w["state"]
    nbytes = (w["inner"] + 2 * w["state"] + w["heads"] + w["inner"]) * dtype_bytes
    return roofline.bound_s(tokens * layers * flops, tokens * layers * nbytes)


def mamba_conv_bound_s(cfg: dict, tokens: int, dtype_bytes: int = 2) -> float:
    """The Mamba layers' convolutions over ``tokens`` live tokens: x, B and
    C read and written once each, in bf16."""
    per_token = 2.0 * mamba_widths(cfg)["conv"] * dtype_bytes
    return roofline.bound_s(0.0, tokens * counts_by_kind(cfg)["mamba"] * per_token)


def gated_norm_bound_s(cfg: dict, tokens: int, dtype_bytes: int = 2) -> float:
    """The Mamba layers' gated norms over ``tokens`` live tokens: y and z
    read and the output written once, in bf16."""
    per_token = 3.0 * mamba_widths(cfg)["inner"] * dtype_bytes
    return roofline.bound_s(0.0, tokens * counts_by_kind(cfg)["mamba"] * per_token)


def expert_weight_bytes(cfg: dict, dtype_bytes: int = 2) -> float:
    """One layer's held experts' weights, each read once."""
    return held_experts(cfg) * 3.0 * cfg["hidden_size"] * cfg["intermediate_size"] * dtype_bytes


def moe_bound_s(cfg: dict, held_assignments: int, layer_calls: int) -> float:
    """The held experts' FFN over ``held_assignments`` assignments (every
    layer's, summed) in ``layer_calls`` layer calls: their operations at the
    bf16 peak, or each call's held expert weights read once, the larger."""
    flops = held_assignments * expert_flops_per_assignment(cfg)
    return roofline.bound_s(flops, layer_calls * expert_weight_bytes(cfg))
