"""Weight bridges into the port's models.

- ``encoder_state_dict_from_flax``: the Flax ``TextEncoder`` tree
  (``rag_arc_tpu/models/encoder.py``) → the port's ``TextEncoder``;
- ``causal_lm_state_dict_from_flax``: the Flax ``CausalLM`` tree → the
  port's ``CausalLM``;
- ``qwen3_state_dict_from_flax``: the ``FlaxQwen3LM`` tree
  (``rag_arc_tpu/models/qwen3.py``) → the port's ``Qwen3LM``;
- ``qwen3_state_dict_from_hf``: an HF ``Qwen3ForCausalLM`` state_dict →
  the port's ``Qwen3LM``;
- ``lfm2_moe_state_dict_from_hf``: an HF LFM2 / LFM2-MoE causal LM
  state_dict (``Lfm2ForCausalLM``, ``lfm2_moe``) → the port's
  ``Lfm2MoeLM``;
- ``granite_hybrid_state_dict_from_hf``: an HF Granite 4.0-H causal LM
  state_dict (``GraniteMoeHybridForCausalLM``, ``granitemoehybrid``) → the
  port's ``GraniteHybridLM``, its experts cut to the held range;
- ``bert_state_dict_from_flax``: the ``FlaxBertModel`` tree
  (``rag_arc_tpu/models/bert.py``) → the port's ``BertModel``, whose
  names are HF's (an HF state_dict loads into it as it is).

Flax trees come in as numpy arrays, so both packages run on identical
weights; the bridges need numpy and torch only.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_BLOCK_LAYERS = ("ln_attn", "qkv", "attn_out", "ln_mlp", "mlp_up", "mlp_down")


def _tensor(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _layer(prefix: str, p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    if "kernel" in p:  # Dense: Flax kernel is (in, out), Linear weight (out, in)
        return {
            f"{prefix}.weight": _tensor(p["kernel"]).T.contiguous(),
            f"{prefix}.bias": _tensor(p["bias"]),
        }
    return {  # LayerNorm
        f"{prefix}.weight": _tensor(p["scale"]),
        f"{prefix}.bias": _tensor(p["bias"]),
    }


def encoder_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``TextEncoder`` params (the ``init`` result, or its
    ``"params"`` entry) → the port's ``TextEncoder`` state_dict (f32)."""
    if "params" in params:
        params = params["params"]
    trunk = params["trunk"]
    out = {
        "trunk.tok_embed.weight": _tensor(trunk["tok_embed"]["embedding"]),
        "trunk.pos_embed.weight": _tensor(trunk["pos_embed"]["embedding"]),
        **_layer("trunk.ln_final", trunk["ln_final"]),
    }
    depth = sum(1 for name in trunk if name.startswith("block_"))
    for i in range(depth):
        block = trunk[f"block_{i}"]
        for name in _BLOCK_LAYERS:
            out.update(_layer(f"trunk.blocks.{i}.{name}", block[name]))
    return out


def causal_lm_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``CausalLM`` params → the port's ``CausalLM`` state_dict (f32):
    the encoder trunk plus the ``lm_head`` Dense."""
    if "params" in params:
        params = params["params"]
    out = encoder_state_dict_from_flax({"trunk": params["trunk"]})
    out.update(_layer("lm_head", params["lm_head"]))
    return out


def _dense_weight(kernel: Any) -> torch.Tensor:
    return _tensor(kernel).T.contiguous()


def qwen3_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``FlaxQwen3LM`` params → the port's ``Qwen3LM`` state_dict
    (f32), keeping the fused ``qkv_proj`` and ``gateup_proj``. A tree
    without ``lm_head`` is a tied-embedding model."""
    if "params" in params:
        params = params["params"]
    out = {
        "embed_tokens.weight": _tensor(params["embed_tokens"]["embedding"]),
        "norm.weight": _tensor(params["norm"]["weight"]),
    }
    if "lm_head" in params:
        out["lm_head.weight"] = _dense_weight(params["lm_head"]["kernel"])
    depth = sum(1 for name in params if name.startswith("layers_"))
    for i in range(depth):
        p, pre = params[f"layers_{i}"], f"layers.{i}"
        attn = p["self_attn"]
        out.update({
            f"{pre}.input_layernorm.weight": _tensor(p["input_layernorm"]["weight"]),
            f"{pre}.post_attention_layernorm.weight": _tensor(
                p["post_attention_layernorm"]["weight"]),
            f"{pre}.self_attn.qkv_proj.weight": _dense_weight(attn["qkv_proj"]["kernel"]),
            f"{pre}.self_attn.o_proj.weight": _dense_weight(attn["o_proj"]["kernel"]),
            f"{pre}.self_attn.q_norm.weight": _tensor(attn["q_norm"]["weight"]),
            f"{pre}.self_attn.k_norm.weight": _tensor(attn["k_norm"]["weight"]),
            f"{pre}.gateup_proj.weight": _dense_weight(p["gateup_proj"]["kernel"]),
            f"{pre}.down_proj.weight": _dense_weight(p["down_proj"]["kernel"]),
        })
    return out


def qwen3_state_dict_from_hf(state_dict: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """An HF ``Qwen3ForCausalLM`` state_dict → the port's ``Qwen3LM``
    state_dict (f32), concatenating q|k|v into ``qkv_proj`` and gate|up
    into ``gateup_proj`` as ``rag_arc_tpu.models.qwen3.convert_torch_qwen3``
    does. ``cfg`` is the port's ``Qwen3Config``; with
    ``tie_word_embeddings`` the HF ``lm_head`` (a view of the embedding
    table) is not carried."""
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}

    def w(key: str) -> torch.Tensor:
        t = sd[f"{key}.weight"]
        return (t.detach() if hasattr(t, "detach") else torch.as_tensor(t)).float().cpu()

    out = {"embed_tokens.weight": w("embed_tokens"), "norm.weight": w("norm")}
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = w("lm_head")
    for i in range(cfg.num_hidden_layers):
        pre = f"layers.{i}"
        out.update({
            f"{pre}.input_layernorm.weight": w(f"{pre}.input_layernorm"),
            f"{pre}.post_attention_layernorm.weight": w(f"{pre}.post_attention_layernorm"),
            f"{pre}.self_attn.qkv_proj.weight": torch.cat(
                [w(f"{pre}.self_attn.{n}_proj") for n in ("q", "k", "v")]),
            f"{pre}.self_attn.o_proj.weight": w(f"{pre}.self_attn.o_proj"),
            f"{pre}.self_attn.q_norm.weight": w(f"{pre}.self_attn.q_norm"),
            f"{pre}.self_attn.k_norm.weight": w(f"{pre}.self_attn.k_norm"),
            f"{pre}.gateup_proj.weight": torch.cat(
                [w(f"{pre}.mlp.gate_proj"), w(f"{pre}.mlp.up_proj")]),
            f"{pre}.down_proj.weight": w(f"{pre}.mlp.down_proj"),
        })
    return out


def lfm2_moe_state_dict_from_hf(state_dict: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """An HF LFM2 causal LM state_dict → the port's ``Lfm2MoeLM`` state_dict
    (f32). ``cfg`` is the port's ``Lfm2MoeConfig``. q|k|v are concatenated
    into ``qkv_proj``, each SwiGLU's w1|w3 into ``gateup_proj`` (w2 is
    ``down_proj``), the sparse blocks' per-expert ``experts.<e>.w1/w2/w3``
    stacked into (E, 2I, H) and (E, H, I), the conv's (H, 1, K) weight
    taken as (H, K). With ``tie_word_embeddings`` the HF ``lm_head`` (the
    embedding table) is not carried."""
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}

    def t(key: str) -> torch.Tensor:
        v = sd[key]
        return (v.detach() if hasattr(v, "detach") else torch.as_tensor(v)).float().cpu()

    def w(key: str) -> torch.Tensor:
        return t(f"{key}.weight")

    out = {"embed_tokens.weight": w("embed_tokens"),
           "embedding_norm.weight": w("embedding_norm")}
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = w("lm_head")
    for i, kind in enumerate(cfg.layer_types):
        pre = f"layers.{i}"
        out[f"{pre}.operator_norm.weight"] = w(f"{pre}.operator_norm")
        out[f"{pre}.ffn_norm.weight"] = w(f"{pre}.ffn_norm")
        if kind == "full_attention":
            a = f"{pre}.self_attn"
            out.update({
                f"{a}.qkv_proj.weight": torch.cat([w(f"{a}.{n}_proj") for n in ("q", "k", "v")]),
                f"{a}.o_proj.weight": w(f"{a}.out_proj"),
                f"{a}.q_norm.weight": w(f"{a}.q_layernorm"),
                f"{a}.k_norm.weight": w(f"{a}.k_layernorm"),
            })
        else:
            c = f"{pre}.conv"
            out.update({
                f"{c}.in_proj.weight": w(f"{c}.in_proj"),
                f"{c}.weight": w(f"{c}.conv").reshape(cfg.hidden_size, cfg.conv_L_cache),
                f"{c}.out_proj.weight": w(f"{c}.out_proj"),
            })
        f = f"{pre}.feed_forward"
        if i < cfg.num_dense_layers:
            out[f"{f}.gateup_proj.weight"] = torch.cat([w(f"{f}.w1"), w(f"{f}.w3")])
            out[f"{f}.down_proj.weight"] = w(f"{f}.w2")
            continue
        experts = range(cfg.num_experts)
        out.update({
            f"{f}.gate.weight": w(f"{f}.gate"),
            f"{f}.expert_bias": (t(f"{f}.expert_bias") if f"{f}.expert_bias" in sd
                                 else torch.zeros(cfg.num_experts)),
            f"{f}.gateup_proj": torch.stack([
                torch.cat([w(f"{f}.experts.{e}.w1"), w(f"{f}.experts.{e}.w3")])
                for e in experts]),
            f"{f}.down_proj": torch.stack([w(f"{f}.experts.{e}.w2") for e in experts]),
        })
    return out


def bert_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``FlaxBertModel`` params (the ``init`` result or
    ``convert_torch_bert``'s, or its ``"params"`` entry) → the port's
    ``BertModel`` state_dict (f32, HF names)."""
    if "params" in params:
        params = params["params"]
    out = {
        "embeddings.word_embeddings.weight": _tensor(params["tok"]["embedding"]),
        "embeddings.position_embeddings.weight": _tensor(params["pos"]["embedding"]),
        "embeddings.token_type_embeddings.weight": _tensor(params["typ"]["embedding"]),
        **_layer("embeddings.LayerNorm", params["ln_embed"]),
        **_layer("pooler.dense", params["pooler"]),
    }
    depth = sum(1 for name in params if name.startswith("layer_"))
    names = {
        "q": "attention.self.query",
        "k": "attention.self.key",
        "v": "attention.self.value",
        "attn_out": "attention.output.dense",
        "ln_attn": "attention.output.LayerNorm",
        "intermediate": "intermediate.dense",
        "output": "output.dense",
        "ln_out": "output.LayerNorm",
    }
    for i in range(depth):
        for flax_name, hf_name in names.items():
            out.update(_layer(f"encoder.layer.{i}.{hf_name}", params[f"layer_{i}"][flax_name]))
    return out


def granite_hybrid_state_dict_from_hf(state_dict: Mapping[str, Any],
                                      cfg) -> Dict[str, torch.Tensor]:
    """An HF Granite 4.0-H causal LM state_dict → the port's
    ``GraniteHybridLM`` state_dict (f32). ``cfg`` is the port's
    ``GraniteHybridConfig``: q|k|v are concatenated into ``qkv_proj``, the
    router's ``router.layer`` becomes ``router``, the experts'
    ``input_linear`` (E, 2I, H) and ``output_linear`` (E, H, I) become
    ``gateup_proj`` and ``down_proj`` cut to ``cfg.held``, the shared
    expert's ``input_linear`` / ``output_linear`` its ``gateup_proj`` /
    ``down_proj``, the conv's (C, 1, K) weight is taken as (C, K). With
    ``tie_word_embeddings`` the HF ``lm_head`` (the embedding table) is not
    carried."""
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}

    def t(key: str) -> torch.Tensor:
        v = sd[key]
        return (v.detach() if hasattr(v, "detach") else torch.as_tensor(v)).float().cpu()

    lo, hi = cfg.held
    out = {"embed_tokens.weight": t("embed_tokens.weight"), "norm.weight": t("norm.weight")}
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = t("lm_head.weight")
    for i, kind in enumerate(cfg.layer_types):
        p = f"layers.{i}."
        for name in ("input_layernorm.weight", "post_attention_layernorm.weight"):
            out[p + name] = t(p + name)
        if kind == "attention":
            a = p + "self_attn."
            out[a + "qkv_proj.weight"] = torch.cat(
                [t(a + f"{x}_proj.weight") for x in "qkv"], dim=0)
            out[a + "o_proj.weight"] = t(a + "o_proj.weight")
        else:
            m = p + "mamba."
            names = ["in_proj.weight", "dt_bias", "A_log", "D", "norm.weight", "out_proj.weight"]
            if cfg.mamba_conv_bias:
                names.append("conv1d.bias")
            for name in names:
                out[m + name] = t(m + name)
            out[m + "conv1d.weight"] = t(m + "conv1d.weight").reshape(cfg.conv_dim, -1)
        f = p + "block_sparse_moe."
        out[f + "router.weight"] = t(f + "router.layer.weight")
        out[f + "gateup_proj"] = t(f + "input_linear.weight")[lo:hi].contiguous()
        out[f + "down_proj"] = t(f + "output_linear.weight")[lo:hi].contiguous()
        out[p + "shared_mlp.gateup_proj.weight"] = t(p + "shared_mlp.input_linear.weight")
        out[p + "shared_mlp.down_proj.weight"] = t(p + "shared_mlp.output_linear.weight")
    return out
