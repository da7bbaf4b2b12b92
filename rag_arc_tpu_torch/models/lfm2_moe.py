"""LFM2-MoE causal LM (LiquidAI's LFM2-8B-A1B, HF ``model_type`` ``lfm2_moe``).

No counterpart in the JAX package. A hybrid stack whose layers are not all
alike: ``layer_types`` gives each layer its sequence mixer,

- ``"conv"``: a gated short convolution (HF ``Lfm2ShortConv``):
  ``in_proj`` → ``[B | C | x]``, ``y = C · conv_K(B · x)`` depthwise and
  causal over K = ``conv_L_cache`` taps, then ``out_proj``
  (``ops/short_conv.py``);
- ``"full_attention"``: grouped-query attention with per-head QK RMSNorm
  and RoPE, as in Qwen3 (``models/qwen3.py``'s ``Qwen3Attention``, its
  ``rope_prep`` and ``flash_attention`` kernels on the card), head dim
  hidden / heads;

and ``num_dense_layers`` its feed-forward: the first ones a dense SwiGLU
of ``intermediate_size``, the rest a sparse block of ``num_experts``
SwiGLU experts of ``moe_intermediate_size`` with a sigmoid router that
chooses ``num_experts_per_tok`` by score plus ``expert_bias``
(``ops/moe.py``). Each layer is pre-norm (``operator_norm``, ``ffn_norm``)
with residuals; a final ``embedding_norm``; RMSNorm is ``w · x̂``. Every
residual add and the norm after it run as one ``ops/rms_norm.py`` pass
(the plain chain on the einsum path) through ``decoder.residual_norm``.

Parameters live in ``param_dtype`` and are cast to the compute ``dtype``
where used; norms and the router compute in f32. The HF names map as
``models/convert.py::lfm2_moe_state_dict_from_hf`` says (q|k|v fused into
``qkv_proj``, each dense or expert w1|w3 into ``gateup_proj``, the conv's
weight without its middle axis).

The entry points are ``models/decoder.py``'s ``DecoderLM``'s, as
``Qwen3LM``'s: ``hidden``, ``last_logits`` (left-padded rows: padding
reads as zero to the conv, as HF's ``apply_mask_to_padding_states``
makes it, and is not routed), ``last_logits_packed`` (several sequences a
row: the conv stops at each segment start as attention does) and
``forward``; this module supplies the layers and their context. The new
ops are called through this module's names (``short_conv``,
``moe_route``, ``moe_experts``) so that a harness can wrap them; the
norms go through ``decoder.residual_norm``, so wrapping
``models/decoder.py``'s ``add_rms_norm`` reaches both models. ``hidden``,
``last_logits`` and ``last_logits_packed`` take ``counts``, a (3,) int64
device tensor that gains ``device_counts``: the routed assignments, those
on held experts (every expert is held here, so the two agree) and the
busiest expert's rows, summed over the MoE layers.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rag_arc_tpu_torch.models.decoder import DecoderLM, RMSNorm, cast_linear, residual_norm
from rag_arc_tpu_torch.models.qwen3 import (
    ATTN_IMPLS, AttentionContext, Qwen3Attention, Qwen3Config, attention_context,
    packed_attention_context,
)
from rag_arc_tpu_torch.ops.moe import moe_experts, moe_route
from rag_arc_tpu_torch.ops.short_conv import short_conv

LAYER_KINDS = ("conv", "full_attention")

# LFM2-8B-A1B's config.json: attention at layers 2, 6, 10, 14, 18 and 21
LFM2_8B_A1B_LAYER_TYPES = tuple(
    "full_attention" if i in (2, 6, 10, 14, 18, 21) else "conv" for i in range(24))


@dataclasses.dataclass(frozen=True)
class Lfm2MoeConfig:
    """Defaults: LFM2-8B-A1B's published config."""

    vocab_size: int = 65536
    hidden_size: int = 2048
    intermediate_size: int = 7168
    moe_intermediate_size: int = 1792
    num_hidden_layers: int = 24
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 128000
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    conv_L_cache: int = 3
    layer_types: Tuple[str, ...] = LFM2_8B_A1B_LAYER_TYPES
    num_dense_layers: int = 2
    num_experts: int = 32
    num_experts_per_tok: int = 4
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    use_expert_bias: bool = True
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    attn_impl: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if len(self.layer_types) != self.num_hidden_layers:
            raise ValueError(f"{len(self.layer_types)} layer_types for "
                             f"{self.num_hidden_layers} layers")
        if set(self.layer_types) - set(LAYER_KINDS):
            raise ValueError(f"layer_types must be in {LAYER_KINDS}, got {self.layer_types}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {self.attn_impl!r}")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must divide into the attention heads")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def moe_layers(self) -> int:
        return max(0, self.num_hidden_layers - self.num_dense_layers)

    def attention(self) -> Qwen3Config:
        """The attention layers' settings, as the shared Qwen3 module takes them."""
        return Qwen3Config(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads, head_dim=self.head_dim,
            max_position_embeddings=self.max_position_embeddings, rope_theta=self.rope_theta,
            rms_norm_eps=self.norm_eps, dtype=self.dtype, param_dtype=self.param_dtype,
            attn_impl=self.attn_impl)

    @classmethod
    def tiny(cls, **kw) -> "Lfm2MoeConfig":
        base = dict(
            vocab_size=128, hidden_size=32, intermediate_size=64, moe_intermediate_size=16,
            num_hidden_layers=6,
            layer_types=("conv", "conv", "full_attention", "conv", "conv", "full_attention"),
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
            rope_theta=10000.0, num_dense_layers=2, num_experts=8, num_experts_per_tok=2,
        )
        base.update(kw)
        return cls(**base)


@dataclasses.dataclass
class _Lfm2Context:
    """What every layer of one forward shares."""

    attn: AttentionContext           # the attention layers'
    seg: torch.Tensor                # (B, L) int32: the conv's segments, −1 on padding
    live: torch.Tensor               # (B · L,) bool: the tokens the router routes
    counts: Optional[torch.Tensor]   # (3,) int64, or None

    @property
    def fused(self) -> bool:
        return self.attn.fused


class ShortConv(nn.Module):
    def __init__(self, cfg: Lfm2MoeConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        kw = dict(bias=False, device=device, dtype=cfg.param_dtype)
        self.in_proj = nn.Linear(h, 3 * h, **kw)
        self.weight = nn.Parameter(torch.empty(h, cfg.conv_L_cache, device=device,
                                               dtype=cfg.param_dtype))
        self.out_proj = nn.Linear(h, h, **kw)

    def forward(self, x: torch.Tensor, ctx: _Lfm2Context) -> torch.Tensor:
        dt = self.cfg.dtype
        y = short_conv(cast_linear(self.in_proj, x, dt), self.weight, ctx.seg)
        return cast_linear(self.out_proj, y, dt)


class DenseMLP(nn.Module):
    def __init__(self, cfg: Lfm2MoeConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(bias=False, device=device, dtype=cfg.param_dtype)
        self.gateup_proj = nn.Linear(cfg.hidden_size, 2 * cfg.intermediate_size, **kw)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x: torch.Tensor, ctx: _Lfm2Context) -> torch.Tensor:
        dt, inter = self.cfg.dtype, self.cfg.intermediate_size
        gu = cast_linear(self.gateup_proj, x, dt)
        return cast_linear(self.down_proj, F.silu(gu[..., :inter]) * gu[..., inter:], dt)


class SparseMoE(nn.Module):
    def __init__(self, cfg: Lfm2MoeConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, e, inter = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
        self.gate = nn.Linear(h, e, bias=False, device=device, dtype=cfg.param_dtype)
        self.register_buffer("expert_bias", torch.zeros(e, device=device, dtype=torch.float32))
        self.gateup_proj = nn.Parameter(torch.empty(e, 2 * inter, h, device=device,
                                                    dtype=cfg.param_dtype))
        self.down_proj = nn.Parameter(torch.empty(e, h, inter, device=device,
                                                  dtype=cfg.param_dtype))

    def forward(self, x: torch.Tensor, ctx: _Lfm2Context) -> torch.Tensor:
        cfg = self.cfg
        flat = x.reshape(-1, cfg.hidden_size)
        routing = moe_route(
            flat, self.gate.weight, self.expert_bias if cfg.use_expert_bias else None,
            cfg.num_experts_per_tok, norm_topk_prob=cfg.norm_topk_prob,
            routed_scaling_factor=cfg.routed_scaling_factor, live=ctx.live, counts=ctx.counts)
        out = moe_experts(flat, routing, self.gateup_proj.to(cfg.dtype),
                          self.down_proj.to(cfg.dtype))
        return out.view_as(x)


class Lfm2MoeLayer(nn.Module):
    def __init__(self, cfg: Lfm2MoeConfig, index: int, device=None):
        super().__init__()
        norm = dict(dtype=cfg.dtype, device=device, param_dtype=cfg.param_dtype)
        self.operator_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, **norm)
        if cfg.layer_types[index] == "full_attention":
            self.self_attn = Qwen3Attention(cfg.attention(), device)
        else:
            self.conv = ShortConv(cfg, device)
        self.ffn_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, **norm)
        self.feed_forward = (DenseMLP(cfg, device) if index < cfg.num_dense_layers
                             else SparseMoE(cfg, device))

    def forward(self, x: torch.Tensor, delta: Optional[torch.Tensor],
                ctx: _Lfm2Context) -> Tuple[torch.Tensor, torch.Tensor]:
        """As ``Qwen3Layer.forward``: the stream with this layer's mixer
        added, and this layer's feed-forward output still to be added."""
        x, h = residual_norm(x, delta, self.operator_norm, ctx.fused)
        mixed = self.self_attn(h, ctx.attn) if hasattr(self, "self_attn") else self.conv(h, ctx)
        x, h = residual_norm(x, mixed, self.ffn_norm, ctx.fused)
        return x, self.feed_forward(h, ctx)


class Lfm2MoeLM(DecoderLM):
    """``DecoderLM``'s entry points over LFM2-MoE layers."""

    device_counts = ("moe_assignments", "moe_held", "moe_busiest")

    def __init__(self, cfg: Lfm2MoeConfig, device=None):
        super().__init__(cfg, (Lfm2MoeLayer(cfg, i, device)
                               for i in range(cfg.num_hidden_layers)),
                         "embedding_norm", cfg.norm_eps, device)
        self.attn_cfg = cfg.attention()

    def _context(self, mask: torch.Tensor, counts=None) -> _Lfm2Context:
        seg = mask.to(torch.int32) - 1
        return _Lfm2Context(attention_context(self.attn_cfg, mask), seg.contiguous(),
                            mask.reshape(-1), counts)

    def _packed_context(self, positions: torch.Tensor, seg: torch.Tensor,
                        counts=None) -> _Lfm2Context:
        seg = seg.to(torch.int32).contiguous()
        return _Lfm2Context(packed_attention_context(self.attn_cfg, positions, seg), seg,
                            (seg >= 0).reshape(-1), counts)


EXPERT_BIAS_STD = 0.05


@torch.no_grad()
def init_lfm2_moe(cfg: Lfm2MoeConfig, seed: int, device: torch.device | str) -> Lfm2MoeLM:
    """An Lfm2MoeLM with seeded random weights: every matrix (the conv's
    taps and the experts' too) N(0, 0.02), ``expert_bias`` N(0, 0.05) so
    that the biased choice and the unbiased weights differ, norm scales 1,
    in ``param_dtype``."""
    model = Lfm2MoeLM(cfg, device=device)
    gen = torch.Generator(device=torch.device(device)).manual_seed(int(seed))
    for name, p in model.named_parameters():
        if not name.endswith("norm.weight"):
            p.normal_(0.0, 0.02, generator=gen)
    for name, b in model.named_buffers():
        if name.endswith("expert_bias"):
            b.normal_(0.0, EXPERT_BIAS_STD, generator=gen)
    return model.eval()


def config_from_hf(hf: Dict[str, Any], **kw) -> Lfm2MoeConfig:
    """An HF ``lfm2_moe`` config.json (as a dict) → ``Lfm2MoeConfig``."""
    if hf.get("conv_bias"):
        raise ValueError("conv_bias is not supported: LFM2-MoE checkpoints have none")
    return Lfm2MoeConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        moe_intermediate_size=hf["moe_intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf["num_key_value_heads"],
        max_position_embeddings=hf["max_position_embeddings"],
        rope_theta=float(hf["rope_theta"]), norm_eps=float(hf["norm_eps"]),
        conv_L_cache=hf["conv_L_cache"], layer_types=tuple(hf["layer_types"]),
        num_dense_layers=hf["num_dense_layers"], num_experts=hf["num_experts"],
        num_experts_per_tok=hf["num_experts_per_tok"], norm_topk_prob=hf["norm_topk_prob"],
        routed_scaling_factor=float(hf["routed_scaling_factor"]),
        use_expert_bias=hf["use_expert_bias"],
        tie_word_embeddings=hf.get("tie_word_embeddings", hf.get("tie_embedding", True)), **kw)


def load_hf_lfm2_moe(path: str, *, device: torch.device | str):
    """Load a local HF LFM2-MoE checkpoint directory (``config.json``,
    ``*.safetensors``; nothing is downloaded) into the port's model, in
    bfloat16 as it is served.
    Returns (model, state_dict, hf_tokenizer), the triple
    ``CrossEncoderReranker.from_causal_lm`` takes."""
    from safetensors.torch import load_file
    from transformers import AutoTokenizer

    from rag_arc_tpu_torch.models.convert import lfm2_moe_state_dict_from_hf

    root = Path(path)
    cfg = config_from_hf(json.loads((root / "config.json").read_text()),
                         dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    hf_state: Dict[str, torch.Tensor] = {}
    for f in sorted(root.glob("*.safetensors")):
        hf_state.update(load_file(str(f)))
    state = lfm2_moe_state_dict_from_hf(hf_state, cfg)
    model = Lfm2MoeLM(cfg, device="meta").to_empty(device=device)
    model.load_state_dict(state)
    return model.eval(), state, AutoTokenizer.from_pretrained(path)
