"""Granite 4.0-H causal LM (IBM's granite-4.0-h-small, HF ``model_type``
``granitemoehybrid``).

No counterpart in the JAX package. A hybrid stack whose ``layer_types``
give each layer its sequence mixer,

- ``"mamba"``: a Mamba-2 mixer (HF ``GraniteMoeHybridMambaLayer``):
  ``in_proj`` → ``[z | xBC | dt]``; ``xBC`` through a depthwise causal
  conv of ``mamba_d_conv`` taps with a bias, then SiLU
  (``ops/short_conv.py``'s ``mamba_conv``), split into x (heads × d_head),
  B and C (``d_state`` each, one group); the state-space scan
  ``state_t = exp(dt_t·A)·state_{t−1} + dt_t·x_t ⊗ B_t``,
  ``y_t = state_t·C_t + D·x_t`` with ``dt = softplus(dt + dt_bias)`` and
  ``A = −exp(A_log)`` (``ops/ssd_scan.py``); ``w · rms(y · silu(z))`` over
  all d_inner channels (``ops/rms_norm.py``'s ``gated_rms_norm``); then
  ``out_proj``;
- ``"attention"``: grouped-query attention with no position embedding
  (``position_embedding_type`` ``nope``): q, k, v projections, causal
  softmax attention at scale ``attention_multiplier``
  (``ops/flash_attention.py`` on the card), ``o_proj``;

and every layer the same feed-forward: a sparse block of
``num_local_experts`` SwiGLU experts of ``intermediate_size`` whose f32
router chooses ``num_experts_per_tok`` by logit and weights them by the
softmax over the chosen logits (``ops/moe.py``, ``scoring="softmax"``),
beside a shared SwiGLU expert of ``shared_intermediate_size``; the two
outputs are summed. Each layer is pre-norm:
``x = x + m · mixer(rms(x))``, ``x = x + m · (moe(rms(x)) + shared(rms(x)))``
with ``m`` = ``residual_multiplier``; the embeddings are multiplied by
``embedding_multiplier`` on entry, the final norm follows the last layer
and the logits are divided by ``logits_scaling``. RMSNorm is ``w · x̂``.

``held_experts`` (``(lo, hi)``, None for all) is this card's share under
expert parallelism: the router keeps every expert's logit and its top k,
and the layer computes the part of the result its held experts give (the
others' part is left out, as it would come from another card); the
shared expert is computed in full.

Parameters live in ``param_dtype`` and are cast to the compute ``dtype``
where used, but for ``A_log``, ``dt_bias`` and ``D``, kept in f32; the
router, the norms and the scan's state and sums compute in f32 (the card's
scan rounds some of its product operands to bf16, below). The HF
names map as ``models/convert.py::granite_hybrid_state_dict_from_hf``
says (q|k|v fused into ``qkv_proj``, the router's ``router.layer`` as
``router``, the experts' ``input_linear`` / ``output_linear`` as
``gateup_proj`` / ``down_proj`` cut to the held range, the conv's weight
without its middle axis).

Departures from HF's torch path, none of which changes the function
beyond rounding:

- sequences packed several to a row (``last_logits_packed``) restart the
  conv and the scan's state at each segment start, as HF's ``seq_idx``
  does on its CUDA path (its torch path refuses ``seq_idx``); padding adds
  nothing to a state, reads as zero to the conv and is not routed (HF
  zeroes the pads' mixer inputs and outputs);
- the scan runs in chunks of 64 tokens (HF's torch path: 256), which
  changes the order of its f32 sums only; its y is rounded to the compute
  dtype before the gated norm (HF keeps it in f32 there);
- on the card the scan's four products per chunk take bf16 operands with
  f32 sums, as mamba_ssm's kernels do: the masked decay weights, the
  carried state (for its readout C·H only) and the decayed x of the state
  update are each rounded to bf16 for their product; the state itself is
  carried in f32 (``ops/ssd_scan.py``; the CPU's plain scan is f32
  throughout);
- ``dt + dt_bias`` is added in f32 (HF adds in the model's dtype); the
  conv's sum, bias and SiLU round once (HF twice);
- the router's logits are computed in f32 (HF rounds its linear to the
  model's dtype first); the routing weights stay in f32 and are folded
  into each expert's SwiGLU before the down projection, and a token's
  rows are summed in f32 and rounded once (HF rounds the weights to the
  model's dtype and sums the weighted rows in it);
- ``x + m · delta`` is computed in f32 and rounded once, inside the norm
  that follows it (HF rounds the product and then the sum).

The entry points are ``models/decoder.py``'s ``DecoderLM``'s: ``hidden``,
``last_logits`` (left-padded rows), ``last_logits_packed`` and
``forward``. The new ops are called through this module's names
(``mamba_conv``, ``ssd_scan``, ``gated_rms_norm``, ``moe_route``,
``moe_experts``, ``shared_expert``, ``flash_attention``) so that a harness
can wrap them. ``hidden``, ``last_logits`` and ``last_logits_packed``
take ``counts``, a (3,) int64 device tensor that gains ``device_counts``:
the routed assignments, those that landed on held experts, and the
busiest held expert's rows, summed over the layers.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rag_arc_tpu_torch.models.decoder import DecoderLM, RMSNorm, cast_linear, residual_norm
from rag_arc_tpu_torch.models.qwen3 import ATTN_IMPLS, causal_bias, packed_bias
from rag_arc_tpu_torch.ops.flash_attention import flash_attention
from rag_arc_tpu_torch.ops.moe import moe_experts, moe_route
from rag_arc_tpu_torch.ops.rms_norm import gated_rms_norm
from rag_arc_tpu_torch.ops.short_conv import mamba_conv
from rag_arc_tpu_torch.ops.ssd_scan import ssd_scan

LAYER_KINDS = ("mamba", "attention")

# granite-4.0-h-small's config.json: attention at layers 5, 15, 25 and 35
GRANITE_4_H_SMALL_LAYER_TYPES = tuple(
    "attention" if i in (5, 15, 25, 35) else "mamba" for i in range(40))


@dataclasses.dataclass(frozen=True)
class GraniteHybridConfig:
    """Defaults: granite-4.0-h-small's published config, every expert held."""

    vocab_size: int = 100352
    hidden_size: int = 4096
    intermediate_size: int = 768
    shared_intermediate_size: int = 1536
    num_hidden_layers: int = 40
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 131072
    rms_norm_eps: float = 1e-5
    layer_types: Tuple[str, ...] = GRANITE_4_H_SMALL_LAYER_TYPES
    mamba_n_heads: int = 128
    mamba_d_head: int = 64
    mamba_d_state: int = 128
    mamba_n_groups: int = 1
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_conv_bias: bool = True
    num_local_experts: int = 72
    num_experts_per_tok: int = 10
    held_experts: Optional[Tuple[int, int]] = None
    embedding_multiplier: float = 12.0
    attention_multiplier: float = 0.0078125
    residual_multiplier: float = 0.22
    logits_scaling: float = 16.0
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    attn_impl: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if self.held_experts is not None:
            object.__setattr__(self, "held_experts", tuple(self.held_experts))
        if len(self.layer_types) != self.num_hidden_layers:
            raise ValueError(f"{len(self.layer_types)} layer_types for "
                             f"{self.num_hidden_layers} layers")
        if set(self.layer_types) - set(LAYER_KINDS):
            raise ValueError(f"layer_types must be in {LAYER_KINDS}, got {self.layer_types}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {self.attn_impl!r}")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must divide into the attention heads")
        if self.mamba_n_heads * self.mamba_d_head != self.mamba_inner:
            raise ValueError("mamba_n_heads x mamba_d_head must be mamba_expand x hidden_size")
        if self.mamba_n_groups != 1:
            raise ValueError(f"one B/C group is supported, got {self.mamba_n_groups}")
        if self.num_local_experts < 1 or not 0 < self.num_experts_per_tok <= \
                self.num_local_experts:
            raise ValueError("the sparse block needs experts and 1 <= top k <= experts")
        lo, hi = self.held
        if not 0 <= lo < hi <= self.num_local_experts:
            raise ValueError(f"held_experts must lie within [0, {self.num_local_experts}), "
                             f"got {self.held_experts}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def mamba_inner(self) -> int:
        return self.mamba_expand * self.hidden_size

    @property
    def conv_dim(self) -> int:
        return self.mamba_inner + 2 * self.mamba_n_groups * self.mamba_d_state

    @property
    def in_proj_dim(self) -> int:
        return self.mamba_inner + self.conv_dim + self.mamba_n_heads

    @property
    def held(self) -> Tuple[int, int]:
        return self.held_experts or (0, self.num_local_experts)

    @classmethod
    def tiny(cls, **kw) -> "GraniteHybridConfig":
        base = dict(
            vocab_size=128, hidden_size=32, intermediate_size=16, shared_intermediate_size=24,
            num_hidden_layers=4, layer_types=("mamba", "attention", "mamba", "mamba"),
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
            mamba_n_heads=4, mamba_d_head=16, mamba_d_state=8, num_local_experts=8,
            num_experts_per_tok=3, held_experts=(0, 4), attention_multiplier=0.125,
        )
        base.update(kw)
        return cls(**base)


@dataclasses.dataclass
class _GraniteContext:
    """What every layer of one forward shares."""

    fused: bool                      # the kernels (attention, the norms) or plain torch
    seg: torch.Tensor                # (B, L) int32: segments, −1 on padding
    live: torch.Tensor               # (B · L,) bool: the tokens the router routes
    counts: Optional[torch.Tensor]   # (3,) int64, or None
    bias: Optional[torch.Tensor]     # (B, 1, L, L) f32, einsum path


def shared_expert(x: torch.Tensor, gateup: torch.Tensor, down: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """The shared SwiGLU expert: ``down(silu(g) · u)`` with ``[g | u] =
    gateup(x)``, every token."""
    gu = F.linear(x.to(dtype), gateup.to(dtype))
    inter = down.shape[1]
    return F.linear(F.silu(gu[..., :inter]) * gu[..., inter:], down.to(dtype))


class DepthwiseConv(nn.Module):
    """The mixer's conv1d parameters: ``weight`` (C, K), ``bias`` (C,)."""

    def __init__(self, channels: int, taps: int, bias: bool, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, taps, device=device, dtype=dtype))
        self.register_parameter("bias", nn.Parameter(torch.empty(
            channels, device=device, dtype=dtype)) if bias else None)


class MambaMixer(nn.Module):
    def __init__(self, cfg: GraniteHybridConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(bias=False, device=device, dtype=cfg.param_dtype)
        heads = cfg.mamba_n_heads
        self.in_proj = nn.Linear(cfg.hidden_size, cfg.in_proj_dim, **kw)
        self.conv1d = DepthwiseConv(cfg.conv_dim, cfg.mamba_d_conv, cfg.mamba_conv_bias,
                                    device, cfg.param_dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.dt_bias = nn.Parameter(torch.ones(heads, **f32))
        self.A_log = nn.Parameter(torch.zeros(heads, **f32))
        self.D = nn.Parameter(torch.ones(heads, **f32))
        self.norm = RMSNorm(cfg.mamba_inner, cfg.rms_norm_eps, cfg.dtype, device,
                            cfg.param_dtype)
        self.out_proj = nn.Linear(cfg.mamba_inner, cfg.hidden_size, **kw)

    def forward(self, x: torch.Tensor, ctx: _GraniteContext) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        proj = cast_linear(self.in_proj, x, dt)
        inner, conv = cfg.mamba_inner, cfg.conv_dim
        bias = self.conv1d.bias
        xbc = mamba_conv(proj[..., inner:inner + conv], self.conv1d.weight.to(dt),
                         None if bias is None else bias.to(dt), ctx.seg)
        y = ssd_scan(xbc, proj[..., inner + conv:], self.A_log, self.dt_bias, self.D, ctx.seg,
                     heads=cfg.mamba_n_heads, head_dim=cfg.mamba_d_head,
                     d_state=cfg.mamba_d_state)
        g = gated_rms_norm(y, proj[..., :inner], self.norm.weight, self.norm.eps)
        return cast_linear(self.out_proj, g, dt)


class NoPEAttention(nn.Module):
    def __init__(self, cfg: GraniteHybridConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd, nh, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
        kw = dict(bias=False, device=device, dtype=cfg.param_dtype)
        self.qkv_proj = nn.Linear(cfg.hidden_size, (nh + 2 * nkv) * hd, **kw)
        self.o_proj = nn.Linear(nh * hd, cfg.hidden_size, **kw)

    def forward(self, x: torch.Tensor, ctx: _GraniteContext) -> torch.Tensor:
        cfg = self.cfg
        b, l, _ = x.shape
        hd, nh, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
        qkv = cast_linear(self.qkv_proj, x, cfg.dtype)
        q = qkv[..., : nh * hd].reshape(b, l, nh, hd).transpose(1, 2)
        k = qkv[..., nh * hd : (nh + nkv) * hd].reshape(b, l, nkv, hd).transpose(1, 2)
        v = qkv[..., (nh + nkv) * hd :].reshape(b, l, nkv, hd).transpose(1, 2)
        if ctx.fused:
            # no rope pass to lay the heads out: one copy each, then the
            # kernel writes (B, L, NH, D) in place, the layout o_proj reads
            buf = torch.empty((b, l, nh, hd), dtype=qkv.dtype, device=qkv.device)
            flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), ctx.seg,
                            causal=True, sm_scale=cfg.attention_multiplier,
                            out=buf.transpose(1, 2))
            return cast_linear(self.o_proj, buf.view(b, l, nh * hd), cfg.dtype)
        group = nh // nkv
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
        scores = (q.float() @ k.float().transpose(-1, -2)) * cfg.attention_multiplier
        probs = torch.softmax(scores + ctx.bias, dim=-1).to(cfg.dtype)
        out = (probs @ v).transpose(1, 2).reshape(b, l, nh * hd)
        return cast_linear(self.o_proj, out, cfg.dtype)


class SparseMoE(nn.Module):
    def __init__(self, cfg: GraniteHybridConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, inter = cfg.hidden_size, cfg.intermediate_size
        lo, hi = cfg.held
        self.router = nn.Linear(h, cfg.num_local_experts, bias=False, device=device,
                                dtype=cfg.param_dtype)
        self.gateup_proj = nn.Parameter(torch.empty(hi - lo, 2 * inter, h, device=device,
                                                    dtype=cfg.param_dtype))
        self.down_proj = nn.Parameter(torch.empty(hi - lo, h, inter, device=device,
                                                  dtype=cfg.param_dtype))

    def forward(self, x: torch.Tensor, ctx: _GraniteContext) -> torch.Tensor:
        cfg = self.cfg
        flat = x.reshape(-1, cfg.hidden_size)
        routing = moe_route(flat, self.router.weight, None, cfg.num_experts_per_tok,
                            scoring="softmax", held=cfg.held_experts, live=ctx.live,
                            counts=ctx.counts)
        out = moe_experts(flat, routing, self.gateup_proj.to(cfg.dtype),
                          self.down_proj.to(cfg.dtype))
        return out.view_as(x)


class SharedMLP(nn.Module):
    def __init__(self, cfg: GraniteHybridConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(bias=False, device=device, dtype=cfg.param_dtype)
        self.gateup_proj = nn.Linear(cfg.hidden_size, 2 * cfg.shared_intermediate_size, **kw)
        self.down_proj = nn.Linear(cfg.shared_intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x: torch.Tensor, ctx: _GraniteContext) -> torch.Tensor:
        return shared_expert(x, self.gateup_proj.weight, self.down_proj.weight, self.cfg.dtype)


class GraniteHybridLayer(nn.Module):
    def __init__(self, cfg: GraniteHybridConfig, index: int, device=None):
        super().__init__()
        self.cfg = cfg
        norm = dict(dtype=cfg.dtype, device=device, param_dtype=cfg.param_dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **norm)
        if cfg.layer_types[index] == "attention":
            self.self_attn = NoPEAttention(cfg, device)
        else:
            self.mamba = MambaMixer(cfg, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **norm)
        self.block_sparse_moe = SparseMoE(cfg, device)
        self.shared_mlp = SharedMLP(cfg, device)

    def forward(self, x: torch.Tensor, delta: Optional[torch.Tensor],
                ctx: _GraniteContext) -> Tuple[torch.Tensor, torch.Tensor]:
        """As ``Qwen3Layer.forward``, each residual add scaled by the
        residual multiplier: the stream with this layer's mixer added, and
        this layer's feed-forward output (experts and shared expert) still
        to be added."""
        m = self.cfg.residual_multiplier
        x, h = residual_norm(x, delta, self.input_layernorm, ctx.fused, m)
        mixed = self.self_attn(h, ctx) if hasattr(self, "self_attn") else self.mamba(h, ctx)
        x, h = residual_norm(x, mixed, self.post_attention_layernorm, ctx.fused, m)
        return x, self.block_sparse_moe(h, ctx) + self.shared_mlp(h, ctx)


class GraniteHybridLM(DecoderLM):
    """``DecoderLM``'s entry points over Granite 4.0-H layers."""

    device_counts = ("moe_assignments", "moe_held", "moe_busiest")

    def __init__(self, cfg: GraniteHybridConfig, device=None):
        super().__init__(cfg, (GraniteHybridLayer(cfg, i, device)
                               for i in range(cfg.num_hidden_layers)),
                         "norm", cfg.rms_norm_eps, device)
        self.embedding_multiplier = cfg.embedding_multiplier
        self.residual_multiplier = cfg.residual_multiplier
        self.logits_scaling = cfg.logits_scaling

    def _context(self, mask: torch.Tensor, counts=None) -> _GraniteContext:
        fused = self.cfg.attn_impl != "einsum"
        seg = (mask.to(torch.int32) - 1).contiguous()
        return _GraniteContext(fused, seg, mask.reshape(-1), counts,
                               None if fused else causal_bias(mask))

    def _packed_context(self, positions: torch.Tensor, seg: torch.Tensor,
                        counts=None) -> _GraniteContext:
        fused = self.cfg.attn_impl != "einsum"
        seg = seg.to(torch.int32).contiguous()
        return _GraniteContext(fused, seg, (seg >= 0).reshape(-1), counts,
                               None if fused else packed_bias(seg))


DT_RANGE = (0.001, 0.1)
A_RANGE = (1.0, 16.0)


def inverse_softplus(y: torch.Tensor) -> torch.Tensor:
    """x with softplus(x) = y (y > 0)."""
    return y + torch.log(-torch.expm1(-y))


@torch.no_grad()
def init_granite_hybrid(cfg: GraniteHybridConfig, seed: int,
                        device: torch.device | str) -> GraniteHybridLM:
    """A GraniteHybridLM with seeded random weights by Mamba-2's conventions:
    every matrix N(0, 0.02), the conv's taps N(0, 1/sqrt(K)) and its bias
    N(0, 0.02), ``A`` uniform in [1, 16] (``A_log`` its log), ``dt``
    log-uniform in [0.001, 0.1] (``dt_bias`` its inverse softplus), ``D``
    1, norm scales 1, in ``param_dtype`` (the three scan parameters f32)."""
    model = GraniteHybridLM(cfg, device=device)
    gen = torch.Generator(device=torch.device(device)).manual_seed(int(seed))
    lo_dt, hi_dt = math.log(DT_RANGE[0]), math.log(DT_RANGE[1])
    for name, p in model.named_parameters():
        if name.endswith("norm.weight") or name.endswith(".D"):
            p.fill_(1.0)
        elif name.endswith("conv1d.weight"):
            p.normal_(0.0, 1.0 / math.sqrt(cfg.mamba_d_conv), generator=gen)
        elif name.endswith("A_log"):
            p.copy_(torch.log(torch.empty_like(p).uniform_(*A_RANGE, generator=gen)))
        elif name.endswith("dt_bias"):
            step = torch.exp(torch.empty_like(p).uniform_(lo_dt, hi_dt, generator=gen))
            p.copy_(inverse_softplus(step))
        else:
            p.normal_(0.0, 0.02, generator=gen)
    return model.eval()


def config_from_hf(hf: Dict[str, Any], held: Optional[Tuple[int, int]] = None,
                   **kw) -> GraniteHybridConfig:
    """An HF ``granitemoehybrid`` config.json (as a dict) → the port's
    config; ``held`` the range of experts this card holds (None: all)."""
    if hf.get("position_embedding_type") not in (None, "nope"):
        raise ValueError(f"position_embedding_type {hf['position_embedding_type']!r} is not "
                         f"supported: Granite 4.0-H has none (nope)")
    for key in ("attention_bias", "mamba_proj_bias"):
        if hf.get(key):
            raise ValueError(f"{key} is not supported: Granite 4.0-H checkpoints have none")
    n = hf["num_hidden_layers"]
    heads = hf.get("mamba_n_heads", 128)
    expand = hf.get("mamba_expand", 2)
    d_head = hf.get("mamba_d_head", "auto")
    if d_head == "auto":
        d_head = expand * hf["hidden_size"] // heads
    return GraniteHybridConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        shared_intermediate_size=hf["shared_intermediate_size"], num_hidden_layers=n,
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf["num_key_value_heads"],
        max_position_embeddings=hf["max_position_embeddings"],
        rms_norm_eps=float(hf["rms_norm_eps"]),
        layer_types=tuple(hf.get("layer_types") or ("mamba",) * n), mamba_n_heads=heads,
        mamba_d_head=d_head, mamba_d_state=hf["mamba_d_state"],
        mamba_n_groups=hf.get("mamba_n_groups", 1), mamba_d_conv=hf.get("mamba_d_conv", 4),
        mamba_expand=expand, mamba_conv_bias=hf.get("mamba_conv_bias", True),
        num_local_experts=hf["num_local_experts"],
        num_experts_per_tok=hf["num_experts_per_tok"], held_experts=held,
        embedding_multiplier=float(hf["embedding_multiplier"]),
        attention_multiplier=float(hf["attention_multiplier"]),
        residual_multiplier=float(hf["residual_multiplier"]),
        logits_scaling=float(hf["logits_scaling"]),
        tie_word_embeddings=hf.get("tie_word_embeddings", False), **kw)


def load_hf_granite_hybrid(path: str, *, device: torch.device | str,
                           held: Optional[Tuple[int, int]] = None):
    """Load a local HF Granite 4.0-H checkpoint directory (``config.json``,
    ``*.safetensors``; nothing is downloaded) into the port's model, in
    bfloat16 as it is served, holding the experts ``held`` (None: all).
    Returns (model, state_dict, hf_tokenizer), the triple
    ``CrossEncoderReranker.from_causal_lm`` takes."""
    from safetensors.torch import load_file
    from transformers import AutoTokenizer

    from rag_arc_tpu_torch.models.convert import granite_hybrid_state_dict_from_hf

    root = Path(path)
    cfg = config_from_hf(json.loads((root / "config.json").read_text()), held,
                         dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    hf_state: Dict[str, torch.Tensor] = {}
    for f in sorted(root.glob("*.safetensors")):
        hf_state.update(load_file(str(f)))
    state = granite_hybrid_state_dict_from_hf(hf_state, cfg)
    model = GraniteHybridLM(cfg, device="meta").to_empty(device=device)
    model.load_state_dict(state)
    return model.eval(), state, AutoTokenizer.from_pretrained(path)
