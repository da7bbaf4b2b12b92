"""BERT encoder that loads HF checkpoints (counterpart of
``rag_arc_tpu/models/bert.py``).

``BertModel`` computes HF's ``BertModel``: post-LN residuals, token-type
embeddings, LayerNorm epsilon 1e-12, exact GELU and a tanh pooler. Its
submodules carry HF's names, so an HF ``state_dict`` loads with
``load_state_dict`` and no renaming; ``models/convert.py::
bert_state_dict_from_flax`` carries the JAX package's ``FlaxBertModel``
params across. The arithmetic follows the Flax module: parameters in f32,
the forward in ``cfg.dtype``, LayerNorm statistics in f32, attention
scores and softmax in f32 with a -1e9 additive bias on masked keys, the
probabilities cast to ``cfg.dtype``. Attention is plain torch, as the Flax
einsums are: there is no kernel here.

``BertEmbeddings`` does not pad batches to a power of two (a TPU
recompile guard in the JAX package): a text's vector does not depend on
what it is batched with.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

MASK_BIAS = -1e9


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        base = dict(
            vocab_size=128,
            hidden_size=32,
            num_hidden_layers=2,
            num_attention_heads=2,
            intermediate_size=64,
            max_position_embeddings=64,
        )
        base.update(kw)
        return cls(**base)


def _dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(
        x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps
    ).to(dtype)


class _Dense(nn.Module):
    """An HF ``*.dense`` holder."""

    def __init__(self, d_in: int, d_out: int, device):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out, device=device)


class _DenseNorm(nn.Module):
    """An HF ``*.output`` holder: ``dense`` then ``LayerNorm``."""

    def __init__(self, d_in: int, d_out: int, eps: float, device):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out, device=device)
        self.LayerNorm = nn.LayerNorm(d_out, eps=eps, device=device)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        h = cfg.hidden_size
        self.query = nn.Linear(h, h, device=device)
        self.key = nn.Linear(h, h, device=device)
        self.value = nn.Linear(h, h, device=device)


class _Attention(nn.Module):
    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        self.self = _SelfAttention(cfg, device)
        self.output = _DenseNorm(cfg.hidden_size, cfg.hidden_size, cfg.layer_norm_eps, device)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        self.cfg = cfg
        self.attention = _Attention(cfg, device)
        self.intermediate = _Dense(cfg.hidden_size, cfg.intermediate_size, device)
        self.output = _DenseNorm(
            cfg.intermediate_size, cfg.hidden_size, cfg.layer_norm_eps, device
        )

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        sa = self.attention.self
        b, l, _ = x.shape
        q, k, v = (
            _dense(lin, x, dt).reshape(b, l, cfg.num_attention_heads, cfg.head_dim)
            .transpose(1, 2)
            for lin in (sa.query, sa.key, sa.value)
        )
        scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(cfg.head_dim)
        probs = torch.softmax(scores + attn_bias, dim=-1).to(dt)
        ctx = (probs @ v).transpose(1, 2).reshape(b, l, cfg.hidden_size)
        ao = self.attention.output
        x = _layer_norm(ao.LayerNorm, x + _dense(ao.dense, ctx, dt), dt)
        inter = F.gelu(_dense(self.intermediate.dense, x, dt))  # HF: exact GELU
        out = _dense(self.output.dense, inter, dt)
        return _layer_norm(self.output.LayerNorm, x + out, dt)


class _Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h, device=device)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, h, device=device)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h, device=device)
        self.LayerNorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps, device=device)


class _Encoder(nn.Module):
    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg, device) for _ in range(cfg.num_hidden_layers))


class BertModel(nn.Module):
    """``(ids (B, L), mask (B, L), token_type_ids) → (last_hidden_state
    (B, L, H), pooled (B, H))`` in ``cfg.dtype``."""

    def __init__(self, cfg: BertConfig, *, device: torch.device | str):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg, device)
        self.encoder = _Encoder(cfg, device)
        self.pooler = _Dense(cfg.hidden_size, cfg.hidden_size, device)

    def forward(
        self,
        ids: torch.Tensor,
        mask: torch.Tensor,
        token_type_ids: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = self.cfg.dtype
        emb = self.embeddings
        ids = ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(ids)
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        x = (
            emb.word_embeddings(ids).to(dt)
            + emb.position_embeddings(pos).to(dt)
            + emb.token_type_embeddings(token_type_ids.long()).to(dt)
        )
        x = _layer_norm(emb.LayerNorm, x, dt)
        bias = torch.where(mask.bool()[:, None, None, :], 0.0, MASK_BIAS)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        pooled = torch.tanh(_dense(self.pooler.dense, x[:, 0], dt))
        return x, pooled

    def mean_pooled(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Sentence-transformers-style masked mean pooling + L2 norm (f32)."""
        hidden, _ = self(ids, mask)
        m = mask[..., None].float()
        pooled = torch.sum(hidden.float() * m, dim=1) / torch.clamp(
            torch.sum(m, dim=1), min=1.0
        )
        return pooled / torch.clamp(torch.linalg.norm(pooled, dim=-1, keepdim=True), min=1e-12)


@torch.no_grad()
def init_bert(cfg: BertConfig, seed: int, device: torch.device | str) -> BertModel:
    """A BertModel with seeded random weights at HF's initializer scale:
    Linear and Embedding weights N(0, 0.02), biases 0, LayerNorm 1 / 0."""
    model = BertModel(cfg, device=device)
    gen = torch.Generator(device=torch.device(device)).manual_seed(int(seed))
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Embedding)):
            module.weight.normal_(0.0, 0.02, generator=gen)
            if isinstance(module, nn.Linear):
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model.eval()


def load_hf_bert(
    model_name_or_path: str, *, device: torch.device | str
) -> Tuple[BertModel, Dict[str, Any], Any]:
    """Load a local HF BERT checkpoint into the port's model. Returns
    (model, state_dict, hf_tokenizer)."""
    from transformers import AutoConfig, AutoModel, AutoTokenizer

    hf_cfg = AutoConfig.from_pretrained(model_name_or_path)
    cfg = BertConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        num_hidden_layers=hf_cfg.num_hidden_layers,
        num_attention_heads=hf_cfg.num_attention_heads,
        intermediate_size=hf_cfg.intermediate_size,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        type_vocab_size=hf_cfg.type_vocab_size,
    )
    model = BertModel(cfg, device=device)
    wanted = set(model.state_dict())
    # keys with or without a leading "bert." (a task head's checkpoint);
    # buffers such as position_ids are not parameters of this model
    state_dict = {
        k.removeprefix("bert."): v
        for k, v in AutoModel.from_pretrained(model_name_or_path).state_dict().items()
        if k.removeprefix("bert.") in wanted
    }
    model.load_state_dict(state_dict)
    tokenizer = AutoTokenizer.from_pretrained(model_name_or_path)
    return model.eval(), state_dict, tokenizer


class BertEmbeddings:
    """Embeddings over a BertModel (mean pooling, L2 norm:
    sentence-transformers semantics), batched on the model's device."""

    def __init__(self, model: BertModel, tokenizer, batch_size: int = 32):
        from rag_arc_tpu_torch.models.tokenizer import HFTokenizerAdapter

        self.model = model
        self.device = model.embeddings.word_embeddings.weight.device
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
            ids, mask = self.tokenizer.batch_encode(chunk)
            ids_d = torch.from_numpy(np.asarray(ids)).to(self.device)
            mask_d = torch.from_numpy(np.asarray(mask)).to(self.device)
            pending.append((start, self.model.mean_pooled(ids_d, mask_d)))
        for start, emb in pending:  # readbacks after every dispatch
            out[start : start + emb.shape[0]] = emb.cpu().numpy()
        return out

    def embed_documents(self, texts) -> List[List[float]]:
        return self.encode(list(texts)).tolist()

    def embed_query(self, text) -> List[float]:
        return self.encode([text])[0].tolist()
