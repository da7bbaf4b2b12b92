"""Qwen3 causal LM (counterpart of ``rag_arc_tpu/models/qwen3.py``).

The Qwen3 decoder — RMSNorm, per-head QK-norm, RoPE, grouped-query
attention, SwiGLU MLP — with the fused ``qkv_proj`` and ``gateup_proj``
projections and the parameter names of ``FlaxQwen3LM``, so the weight
bridges in ``models/convert.py`` load a Flax tree or an HF
``Qwen3ForCausalLM`` state_dict. The arithmetic follows the Flax
modules: parameters are stored in ``param_dtype`` and cast to the
compute ``dtype`` where used; norms compute in f32; the LM head runs in
f32.

``attn_impl`` picks the attention path:

- ``"auto"`` / ``"flash"``: the fused path — ``ops/rope_prep.py`` (qk-norm,
  rope and transpose in one pass, each KV head written once) then
  ``ops/flash_attention.py`` (causal, the mask as segment ids, the KV
  heads read directly, the output written in place as (B, L, NH, D) for
  o_proj). On a CUDA tensor both launch their kernels, at any length; on
  a CPU tensor both run their plain versions.
- ``"einsum"``: the Flax unfused path in plain torch, with its rounding
  points (RMSNorm rounds to the compute dtype before rope, K/V repeated,
  a −1e9 additive causal & key-live bias, f32 softmax rounded to the
  compute dtype). A reference path, chosen explicitly.

The two agree on live rows. Pad rows differ (the fused path lets a pad
row attend only pads, the einsum path gives it a near-uniform mix), and
nothing reads pad positions: the readouts take the last position of
left-padded rows, or, in ``last_logits_packed``, the last token of each
sequence packed several to a row (segment ids in place of the mask).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rag_arc_tpu_torch.ops.flash_attention import flash_attention
from rag_arc_tpu_torch.ops.rope_prep import rope_cos_sin, rope_prep

MASK_BIAS = -1e9
ATTN_IMPLS = ("auto", "einsum", "flash")


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    vocab_size: int = 151936
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    max_position_embeddings: int = 32768
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    attn_impl: str = "auto"

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {self.attn_impl!r}")

    @classmethod
    def tiny(cls, **kw) -> "Qwen3Config":
        base = dict(
            vocab_size=128,
            hidden_size=32,
            intermediate_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            head_dim=8,
            max_position_embeddings=64,
            rope_theta=10000.0,
        )
        base.update(kw)
        return cls(**base)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype, device=None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.weight.float()).to(self.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, HF half-split convention. x: (B, H, L, D)."""
    d = x.shape[-1]
    cos_full, sin_signed = rope_cos_sin(positions, theta, d)
    cos = cos_full[:, None, :, : d // 2]  # (B, 1, L, D/2)
    sin = sin_signed[:, None, :, d // 2 :]
    x1, x2 = x[..., : d // 2], x[..., d // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _linear(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), lin.weight.to(dtype))


class Qwen3Attention(nn.Module):
    def __init__(self, cfg: Qwen3Config, device=None):
        super().__init__()
        self.cfg = cfg
        hd, nh, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
        kw = dict(bias=False, device=device, dtype=cfg.param_dtype)
        self.qkv_proj = nn.Linear(cfg.hidden_size, (nh + 2 * nkv) * hd, **kw)
        self.o_proj = nn.Linear(nh * hd, cfg.hidden_size, **kw)
        norm = dict(dtype=cfg.dtype, device=device, param_dtype=cfg.param_dtype)
        self.q_norm = RMSNorm(hd, cfg.rms_norm_eps, **norm)
        self.k_norm = RMSNorm(hd, cfg.rms_norm_eps, **norm)

    def forward(self, x: torch.Tensor, ctx: "_Context") -> torch.Tensor:
        cfg = self.cfg
        b, l, _ = x.shape
        hd, nh, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
        qkv = _linear(self.qkv_proj, x, cfg.dtype)
        q = qkv[..., : nh * hd]
        k = qkv[..., nh * hd : (nh + nkv) * hd]
        v = qkv[..., (nh + nkv) * hd :]
        if ctx.fused:
            # one pass: qk-norm + rope + transpose, the KV heads written
            # once (the column slices go in as they are, rows evenly
            # strided); attention reads the KV heads directly and writes
            # (B, L, NH, D) in place, the layout o_proj reads
            q, k, v = rope_prep(
                q, k, v, ctx.cos, ctx.sin, self.q_norm.weight.float(),
                self.k_norm.weight.float(), nh=nh, nkv=nkv, d=hd, eps=cfg.rms_norm_eps,
                repeat_kv=False,
            )
            buf = torch.empty((b, l, nh, hd), dtype=q.dtype, device=q.device)
            flash_attention(q, k, v, ctx.seg, causal=True, sm_scale=1.0 / math.sqrt(hd),
                            out=buf.transpose(1, 2))
            return _linear(self.o_proj, buf.view(b, l, nh * hd), cfg.dtype)
        q = self.q_norm(q.reshape(b, l, nh, hd))
        k = self.k_norm(k.reshape(b, l, nkv, hd))
        q = rope(q.transpose(1, 2), ctx.positions, cfg.rope_theta)
        k = rope(k.transpose(1, 2), ctx.positions, cfg.rope_theta)
        v = v.reshape(b, l, nkv, hd).transpose(1, 2)
        group = nh // nkv
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
        scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(scores + ctx.bias, dim=-1).to(cfg.dtype)
        out = probs @ v
        out = out.transpose(1, 2).reshape(b, l, nh * hd)
        return _linear(self.o_proj, out, cfg.dtype)


class Qwen3Layer(nn.Module):
    def __init__(self, cfg: Qwen3Config, device=None):
        super().__init__()
        self.cfg = cfg
        norm = dict(dtype=cfg.dtype, device=device, param_dtype=cfg.param_dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **norm)
        self.self_attn = Qwen3Attention(cfg, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **norm)
        kw = dict(bias=False, device=device, dtype=cfg.param_dtype)
        self.gateup_proj = nn.Linear(cfg.hidden_size, 2 * cfg.intermediate_size, **kw)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x: torch.Tensor, ctx: "_Context") -> torch.Tensor:
        cfg = self.cfg
        x = x + self.self_attn(self.input_layernorm(x), ctx)
        gu = _linear(self.gateup_proj, self.post_attention_layernorm(x), cfg.dtype)
        gate, up = gu[..., : cfg.intermediate_size], gu[..., cfg.intermediate_size :]
        return x + _linear(self.down_proj, F.silu(gate) * up, cfg.dtype)


@dataclasses.dataclass
class _Context:
    """What every layer of one forward shares."""

    positions: torch.Tensor
    fused: bool
    seg: Optional[torch.Tensor] = None   # (B, L) int32, fused path
    cos: Optional[torch.Tensor] = None   # (B, L, D) f32, fused path
    sin: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None  # (B, 1, L, L) f32, einsum path


class Qwen3LM(nn.Module):
    """``ids (B, L), mask (B, L) bool`` → logits. Rows that several entry
    points read at their last position must be LEFT-padded."""

    def __init__(self, cfg: Qwen3Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(
            cfg.vocab_size, cfg.hidden_size, device=device, dtype=cfg.param_dtype
        )
        self.layers = nn.ModuleList(Qwen3Layer(cfg, device) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, device,
                            cfg.param_dtype)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(
                cfg.hidden_size, cfg.vocab_size, bias=False, device=device,
                dtype=cfg.param_dtype,
            )

    def _context(self, mask: torch.Tensor) -> _Context:
        cfg = self.cfg
        # left-padding aware: positions count from the first live token
        positions = torch.clamp(torch.cumsum(mask.long(), dim=1) - 1, min=0)
        if cfg.attn_impl == "einsum":
            l = mask.shape[1]
            causal = torch.ones(l, l, dtype=torch.bool, device=mask.device).tril()
            bias = torch.where(causal[None, None] & mask[:, None, None, :], 0.0, MASK_BIAS)
            return _Context(positions, fused=False, bias=bias)
        return self._fused_context(positions, mask.to(torch.int32))

    def _packed_context(self, positions: torch.Tensor, seg: torch.Tensor) -> _Context:
        """Several sequences a row: a key is seen by the queries of its own
        segment at or after it, padding (segment −1) by no live query."""
        if self.cfg.attn_impl == "einsum":
            l = seg.shape[1]
            causal = torch.ones(l, l, dtype=torch.bool, device=seg.device).tril()
            seen = causal[None] & (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] >= 0)
            bias = torch.where(seen[:, None], 0.0, MASK_BIAS)
            return _Context(positions, fused=False, bias=bias)
        return self._fused_context(positions, seg)

    def _fused_context(self, positions: torch.Tensor, seg: torch.Tensor) -> _Context:
        # the rope tables are position-only: one pair feeds every layer
        cos, sin = rope_cos_sin(positions, self.cfg.rope_theta, self.cfg.head_dim)
        return _Context(positions, fused=True, seg=seg.to(torch.int32).contiguous(),
                        cos=cos.contiguous(), sin=sin.contiguous())

    def _trunk(self, ids: torch.Tensor, ctx: _Context) -> torch.Tensor:
        """The decoder layers' output (B, L, hidden), before the final norm."""
        x = self.embed_tokens(ids.long()).to(self.cfg.dtype)
        for layer in self.layers:
            x = layer(x, ctx)
        return x

    def hidden(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Final-norm hidden states (B, L, hidden) in the compute dtype."""
        return self.norm(self._trunk(ids, self._context(mask.bool())))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_word_embeddings:
            # Flax Embed.attend: query and table in the compute dtype
            dt = self.cfg.dtype
            return F.linear(x.float().to(dt), self.embed_tokens.weight.to(dt))
        return F.linear(x.float(), self.lm_head.weight.float())

    def embed(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Last-live-token pooled, L2-normalized (B, hidden) f32 embeddings
        (rows left-padded)."""
        pooled = self.hidden(ids, mask)[:, -1, :].float()
        norm = torch.linalg.norm(pooled, dim=-1, keepdim=True)
        return pooled / torch.clamp(norm, min=1e-12)

    def last_logits(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Logits (B, V) at the last position only (rows left-padded): the
        yes/no readout projects one (B, hidden) slice, not (B, L, V)."""
        return self._logits(self.hidden(ids, mask)[:, -1, :])

    def last_logits_packed(
        self, ids: torch.Tensor, positions: torch.Tensor, seg: torch.Tensor,
        last_index: torch.Tensor,
    ) -> torch.Tensor:
        """Logits (N, V) of N sequences packed several to a row
        (``models/packing.py``): ``ids``, ``positions`` (counted from each
        sequence's first token) and ``seg`` (each sequence's slot in its
        row, −1 on padding) are (R, L); ``last_index`` (N,) holds the flat
        ``row * L + column`` of each sequence's last token, and the logits
        come back in its order. Only those N hidden states go through the
        final norm and the vocabulary head."""
        x = self._trunk(ids, self._packed_context(positions.long(), seg))
        last = x.reshape(-1, x.shape[-1]).index_select(0, last_index)
        return self._logits(self.norm(last))

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Logits (B, L, V)."""
        return self._logits(self.hidden(ids, mask))


@torch.no_grad()
def init_qwen3(cfg: Qwen3Config, seed: int, device: torch.device | str) -> Qwen3LM:
    """A Qwen3LM with seeded random weights: every matrix N(0, 0.02), norm
    scales 1, in ``param_dtype`` (the reranker bench's recipe; the numbers
    differ from a Flax init of the same seed)."""
    model = Qwen3LM(cfg, device=device)
    gen = torch.Generator(device=torch.device(device)).manual_seed(int(seed))
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Embedding)):
            module.weight.normal_(0.0, 0.02, generator=gen)
    return model.eval()


class Qwen3Embeddings:
    """Embeddings over a Qwen3 trunk with last-token pooling
    (counterpart of ``rag_arc_tpu.models.qwen3.Qwen3Embeddings``). Batches
    are not padded to a power of two: a text's vector does not depend on
    what it is batched with."""

    def __init__(self, model: Qwen3LM, tokenizer, batch_size: int = 32):
        from rag_arc_tpu_torch.models.tokenizer import HFTokenizerAdapter

        self.model = model
        self.device = model.embed_tokens.weight.device
        self.tokenizer = (
            tokenizer
            if hasattr(tokenizer, "batch_encode")
            else HFTokenizerAdapter(tokenizer, max_len=model.cfg.max_position_embeddings)
        )
        self.batch_size = batch_size
        self.dim = model.cfg.hidden_size

    @torch.inference_mode()
    def encode(self, texts) -> np.ndarray:
        out = np.empty((len(texts), self.dim), dtype=np.float32)
        pending = []
        for start in range(0, len(texts), self.batch_size):
            chunk = [t.replace("\n", " ") for t in texts[start : start + self.batch_size]]
            ids, mask = self.tokenizer.batch_encode(chunk, left_pad=True)
            ids_d = torch.from_numpy(ids).to(self.device)
            mask_d = torch.from_numpy(mask).to(self.device)
            pending.append((start, self.model.embed(ids_d, mask_d)))
        for start, emb in pending:  # readbacks after every dispatch
            out[start : start + emb.shape[0]] = emb.cpu().numpy()
        return out

    def embed_documents(self, texts) -> List[List[float]]:
        return self.encode(list(texts)).tolist()

    def embed_query(self, text) -> List[float]:
        return self.encode([text])[0].tolist()


def load_hf_qwen3(
    model_name_or_path: str, *, device: torch.device | str
) -> Tuple[Qwen3LM, Dict[str, Any], Any]:
    """Load a local HF Qwen3 checkpoint (e.g. a Qwen3-Reranker) into the
    port's model. Returns (model, state_dict, hf_tokenizer), the triple
    ``CrossEncoderReranker.from_causal_lm`` takes."""
    from transformers import AutoConfig, AutoModelForCausalLM, AutoTokenizer

    from rag_arc_tpu_torch.models.convert import qwen3_state_dict_from_hf

    hf = AutoConfig.from_pretrained(model_name_or_path)
    cfg = Qwen3Config(
        vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size,
        intermediate_size=hf.intermediate_size,
        num_hidden_layers=hf.num_hidden_layers,
        num_attention_heads=hf.num_attention_heads,
        num_key_value_heads=hf.num_key_value_heads,
        head_dim=getattr(hf, "head_dim", hf.hidden_size // hf.num_attention_heads),
        max_position_embeddings=hf.max_position_embeddings,
        rope_theta=hf.rope_theta,
        rms_norm_eps=hf.rms_norm_eps,
        tie_word_embeddings=hf.tie_word_embeddings,
    )
    torch_model = AutoModelForCausalLM.from_pretrained(model_name_or_path)
    state = qwen3_state_dict_from_hf(torch_model.state_dict(), cfg)
    model = Qwen3LM(cfg, device=device)
    model.load_state_dict(state)
    tokenizer = AutoTokenizer.from_pretrained(model_name_or_path)
    return model.eval(), state, tokenizer
