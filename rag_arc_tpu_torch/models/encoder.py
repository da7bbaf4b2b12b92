"""Transformer text encoder and causal LM (counterpart of
``rag_arc_tpu/models/encoder.py``).

A pre-LN trunk shared by a masked-mean-pooled, L2-normalized encoder (what
a sentence-transformer computes) and, with causal attention and an f32
vocabulary head, the default cross-encoder scorer. The arithmetic follows the Flax
modules so both packages produce the same vectors from the same weights:

- parameters are stored in ``param_dtype`` (f32) and cast to the compute
  ``dtype`` (bf16 by default) where they are used;
- LayerNorm computes in f32 with epsilon 1e-6 (Flax's default; torch's
  is 1e-5) and returns the compute dtype;
- attention scores are f32, probabilities are cast to the compute dtype,
  masked keys (and, when ``causal``, keys after the query) get a -1e9
  additive bias;
- GELU is the tanh approximation (Flax's ``nn.gelu`` default);
- positions come from ``cumsum(mask) - 1``, not ``arange``.

``TextEncoderFast`` keeps the Flax package's name for its serving twin.
The Flax ``FastBlock`` kept attention in (B, L, H, D) layout to spare the
TPU a transpose; on the card that layout changes nothing, so here it is
``TextEncoder`` itself, bidirectional whatever the config says (as the
Flax ``TextEncoderFast`` is).

None has a hand-written kernel: all are plain PyTorch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
MASK_BIAS = -1e9


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    dim: int = 768
    depth: int = 12
    heads: int = 12
    mlp_ratio: int = 4
    max_len: int = 512
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    causal: bool = False

    @property
    def head_dim(self) -> int:
        if self.dim % self.heads:
            raise ValueError(f"dim {self.dim} not divisible by heads {self.heads}")
        return self.dim // self.heads

    @classmethod
    def tiny(cls, **kw) -> "TransformerConfig":
        """Test-size config (runs in milliseconds on the CPU)."""
        base = dict(vocab_size=512, dim=64, depth=2, heads=4, max_len=64)
        base.update(kw)
        return cls(**base)


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(
        x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), LN_EPS
    ).to(dtype)


def _dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=cfg.param_dtype)
        d = cfg.dim
        self.ln_attn = nn.LayerNorm(d, eps=LN_EPS, **kw)
        self.qkv = nn.Linear(d, 3 * d, **kw)
        self.attn_out = nn.Linear(d, d, **kw)
        self.ln_mlp = nn.LayerNorm(d, eps=LN_EPS, **kw)
        self.mlp_up = nn.Linear(d, cfg.mlp_ratio * d, **kw)
        self.mlp_down = nn.Linear(cfg.mlp_ratio * d, d, **kw)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        """``x`` (B, L, dim) in the compute dtype; ``attn_bias`` (B, 1, L, L)
        or (B, 1, 1, L) f32, 0 where attention is allowed."""
        cfg = self.cfg
        dt = cfg.dtype
        h = _layer_norm(self.ln_attn, x, dt)
        qkv = _dense(self.qkv, h, dt)
        b, l, _ = qkv.shape
        q, k, v = (
            t.reshape(b, l, cfg.heads, cfg.head_dim).transpose(1, 2)
            for t in qkv.split(cfg.dim, dim=-1)
        )
        scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(cfg.head_dim)
        probs = torch.softmax(scores + attn_bias, dim=-1).to(dt)
        ctx = (probs @ v).transpose(1, 2).reshape(b, l, cfg.dim)
        x = x + _dense(self.attn_out, ctx, dt)
        h = _layer_norm(self.ln_mlp, x, dt)
        h = F.gelu(_dense(self.mlp_up, h, dt), approximate="tanh")
        return x + _dense(self.mlp_down, h, dt)


class Trunk(nn.Module):
    """Embeddings + blocks + final LayerNorm, shared by the unpacked and
    packed encoders (one parameter tree, as in the Flax package)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=cfg.param_dtype)
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.pos_embed = nn.Embedding(cfg.max_len, cfg.dim, **kw)
        self.blocks = nn.ModuleList(Block(cfg, device) for _ in range(cfg.depth))
        self.ln_final = nn.LayerNorm(cfg.dim, eps=LN_EPS, **kw)

    def forward(
        self, ids: torch.Tensor, positions: torch.Tensor, attn_bias: torch.Tensor
    ) -> torch.Tensor:
        dt = self.cfg.dtype
        x = self.tok_embed(ids).to(dt) + self.pos_embed(positions).to(dt)
        for block in self.blocks:
            x = block(x, attn_bias)
        return _layer_norm(self.ln_final, x, dt)

    @staticmethod
    def mask_bias(mask: torch.Tensor, causal: bool) -> torch.Tensor:
        """Additive f32 bias from a (B, L) bool mask: -1e9 at masked keys
        ((B, 1, 1, L)), and above the diagonal when causal ((B, 1, L, L))."""
        keep = mask[:, None, None, :]
        if causal:
            l = mask.shape[1]
            keep = keep & torch.ones(l, l, dtype=torch.bool, device=mask.device).tril()
        return torch.where(keep, 0.0, MASK_BIAS)

    @staticmethod
    def segment_bias(seg: torch.Tensor, causal: bool) -> torch.Tensor:
        """Additive f32 bias (B, 1, L, L) for several sequences a row
        (``seg`` (B, L), each token's slot in its row, -1 on padding): a
        query sees the live keys of its own segment, and when causal only
        those at or before it. Padding never matches a live key."""
        keep = (seg[:, None, :, None] == seg[:, None, None, :]) & (seg >= 0)[:, None, None, :]
        if causal:
            l = seg.shape[1]
            keep = keep & torch.ones(l, l, dtype=torch.bool, device=seg.device).tril()
        return torch.where(keep, 0.0, MASK_BIAS)


def l2_normalize_rows(pooled: torch.Tensor) -> torch.Tensor:
    """L2-normalize along the last axis (zero rows stay zero)."""
    norm = torch.sqrt(torch.sum(pooled * pooled, dim=-1, keepdim=True))
    return pooled / torch.clamp(norm, min=1e-12)


def masked_mean_pool(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """f32-accumulated masked mean over the length axis (all-False rows
    pool to exact zero)."""
    m = mask[..., None].float()
    return torch.sum(x.float() * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)


class TextEncoder(nn.Module):
    """Masked-mean-pooled, L2-normalized sentence encoder:
    ``(ids (B, L), mask (B, L) bool) → (B, dim) f32``."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.trunk = Trunk(cfg, device)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        mask = mask.bool()
        # positions from the mask: real tokens embed 0..n-1 whatever the
        # padding (cumsum - 1 equals arange on right-padded rows)
        positions = torch.clamp(torch.cumsum(mask.long(), dim=1) - 1, min=0)
        x = self.trunk(ids, positions, Trunk.mask_bias(mask, self.cfg.causal))
        return l2_normalize_rows(masked_mean_pool(x, mask))


class TextEncoderFast(TextEncoder):
    """The Flax ``TextEncoderFast``'s counterpart: a bidirectional
    TextEncoder (a causal config still attends both ways). Same parameter
    names, so a TextEncoder's state_dict loads as it is."""

    def __init__(self, cfg: TransformerConfig, *, device: torch.device | str):
        super().__init__(dataclasses.replace(cfg, causal=False), device=device)


class CausalLM(nn.Module):
    """Causal trunk + f32 vocabulary head (the cross-encoder's default
    scorer): ``(ids (B, L), mask (B, L)) → (B, L, V)``, and
    ``last_logits_packed`` for sequences packed several to a row."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = dataclasses.replace(cfg, causal=True)
        self.trunk = Trunk(self.cfg, device)
        self.lm_head = nn.Linear(
            cfg.dim, cfg.vocab_size, device=device, dtype=cfg.param_dtype
        )

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.lm_head.weight.float(), self.lm_head.bias.float())

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        mask = mask.bool()
        positions = torch.clamp(torch.cumsum(mask.long(), dim=1) - 1, min=0)
        return self._logits(self.trunk(ids.long(), positions, Trunk.mask_bias(mask, causal=True)))

    def last_logits_packed(
        self, ids: torch.Tensor, positions: torch.Tensor, seg: torch.Tensor,
        last_index: torch.Tensor,
    ) -> torch.Tensor:
        """Logits (N, V) of N sequences packed several to a row, taken as
        ``models/decoder.py``'s ``DecoderLM.last_logits_packed`` takes them:
        each token sees the tokens of its own segment at or before it; only
        the N last tokens go through the head."""
        x = self.trunk(ids.long(), positions.long(), Trunk.segment_bias(seg, causal=True))
        return self._logits(x.reshape(-1, x.shape[-1]).index_select(0, last_index))


class PackedTextEncoder(nn.Module):
    """Sequence-packed twin of TextEncoder: several short documents share
    one row under a block-diagonal attention mask.

    Inputs: ``ids``, ``pos_ids`` (offset within its document) and
    ``seg_ids`` (document slot, -1 on padding), all (B, L). Output:
    (B, max_segments, dim) L2-normalized segment mean-pools; empty slots
    are 0. Pass ``trunk`` to share a TextEncoder's weights."""

    def __init__(
        self,
        cfg: TransformerConfig,
        max_segments: int = 8,
        trunk: Optional[Trunk] = None,
        device=None,
    ):
        super().__init__()
        self.cfg = cfg
        self.max_segments = max_segments
        self.trunk = trunk if trunk is not None else Trunk(cfg, device)

    def forward(
        self, ids: torch.Tensor, pos_ids: torch.Tensor, seg_ids: torch.Tensor
    ) -> torch.Tensor:
        x = self.trunk(ids, pos_ids, Trunk.segment_bias(seg_ids, causal=False))
        slots = torch.arange(self.max_segments, device=seg_ids.device)
        onehot = (seg_ids[..., None] == slots).float()          # (B, L, S)
        sums = torch.einsum("bld,bls->bsd", x.float(), onehot)
        counts = onehot.sum(dim=1)
        return l2_normalize_rows(sums / torch.clamp(counts[..., None], min=1.0))


def _trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """Truncated normal in [-2σ, 2σ] by inverse CDF, driven by ``gen``."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    t.uniform_(2 * lo - 1, 1 - 2 * lo, generator=gen)
    t.erfinv_().mul_(std * math.sqrt(2.0))


@torch.no_grad()
def init_encoder(
    cfg: TransformerConfig, seed: int, device: torch.device | str
) -> TextEncoder:
    """A TextEncoder with seeded random weights, Flax's default scales:
    Dense kernels truncated-normal with variance 1/fan_in, embeddings
    normal with variance 1/dim, biases 0, LayerNorm scale 1.

    The numbers differ from the Flax init of the same seed; tests that
    compare the packages load one set of weights into both
    (``models/convert.py``)."""
    return _init_flax_scales(TextEncoder(cfg, device=device), cfg, seed, device)


@torch.no_grad()
def init_causal_lm(
    cfg: TransformerConfig, seed: int, device: torch.device | str
) -> CausalLM:
    """A CausalLM with seeded random weights at Flax's default scales (as
    :func:`init_encoder`)."""
    return _init_flax_scales(CausalLM(cfg, device=device), cfg, seed, device)


def _init_flax_scales(model: nn.Module, cfg: TransformerConfig, seed: int, device):
    gen = torch.Generator(device=torch.device(device)).manual_seed(int(seed))
    for module in model.modules():
        if isinstance(module, nn.Linear):
            # Flax's truncated normal keeps the variance: 1/fan_in after
            # truncation at 2σ (σ rescaled by 1/0.8796...)
            std = math.sqrt(1.0 / module.in_features) / 0.87962566103423978
            _trunc_normal_(module.weight, std, gen)
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, math.sqrt(1.0 / cfg.dim), generator=gen)
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model.eval()
