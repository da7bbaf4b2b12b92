"""The shell the port's pre-norm decoders share (``models/qwen3.py``,
``models/lfm2_moe.py``, ``models/granite_hybrid.py``): nothing
attention-specific.

- ``RMSNorm``: ``w · x̂`` in f32, rounded to the compute dtype.
- ``residual_norm``: the residual add (scaled by the model's residual
  multiplier, 1 but in Granite) and the RMSNorm after it, one
  ``ops/rms_norm.py`` launch on the kernel path, the plain chain on the
  einsum path. Every norm site of the decoders calls it, so wrapping this
  module's ``add_rms_norm`` reaches all of them.
- ``cast_linear``: a bias-free projection with input and weight cast to
  the compute dtype (parameters live in ``param_dtype``).
- ``DecoderLM``: embeddings, the layers, a final RMSNorm and an f32
  vocabulary head (or the tied embedding table), with every entry point:
  ``hidden``, ``last_logits`` (left-padded rows), ``last_logits_packed``
  (several sequences a row, the reranker's one scoring contract) and
  ``forward``. A subclass builds its layers and supplies its context
  builders; a layer's ``forward(x, delta, ctx)`` returns the stream with
  its mixer added and its feed-forward output still to be added, so each
  residual add runs inside the next norm. A subclass may set
  ``embedding_multiplier`` (the embeddings scaled on entry),
  ``residual_multiplier`` (each residual add's delta scaled) and
  ``logits_scaling`` (the logits divided by it), all 1 here.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rag_arc_tpu_torch.ops.rms_norm import add_rms_norm, add_rms_norm_plain


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype, device=None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return add_rms_norm_plain(x, None, self.weight, self.eps)[1].to(self.dtype)


def residual_norm(x: torch.Tensor, delta: Optional[torch.Tensor], norm: RMSNorm,
                  fused: bool, scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x + scale · delta, norm(x + scale · delta))``: one ``add_rms_norm``
    launch on the kernel path, the plain chain on the einsum path."""
    op = add_rms_norm if fused else add_rms_norm_plain
    return op(x, delta, norm.weight, norm.eps, scale)


def cast_linear(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), lin.weight.to(dtype))


def last_rows(x: torch.Tensor, delta: Optional[torch.Tensor],
              index: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The rows ``index`` of the flattened (B · L, hidden) residual stream
    and of its pending delta, so that the final add and norm run over those
    rows only."""
    def pick(t):
        return t.reshape(-1, t.shape[-1]).index_select(0, index)

    return pick(x), None if delta is None else pick(delta)


class DecoderLM(nn.Module):
    """``ids (B, L), mask (B, L) bool`` → logits. Rows read at their last
    position must be LEFT-padded.

    A subclass passes its layers, the attribute name of its final norm (the
    name its checkpoints use) and that norm's eps, and defines
    ``_context(mask, **kw)`` for left-padded rows and
    ``_packed_context(positions, seg, **kw)`` for packed ones; a context
    has ``fused`` (the kernels or plain torch). Keywords of the entry points
    (``counts`` for ``Lfm2MoeLM``) go to the context builders."""

    embedding_multiplier = 1.0
    residual_multiplier = 1.0
    logits_scaling = 1.0

    def __init__(self, cfg, layers: Iterable[nn.Module], norm_name: str, eps: float,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device,
                                         dtype=cfg.param_dtype)
        self.layers = nn.ModuleList(layers)
        self.norm_name = norm_name
        self.add_module(norm_name, RMSNorm(cfg.hidden_size, eps, cfg.dtype, device,
                                           cfg.param_dtype))
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                     device=device, dtype=cfg.param_dtype)

    def _trunk(self, ids: torch.Tensor, ctx) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The residual stream (B, L, hidden) and the last layer's
        feed-forward output still to be added to it (None without layers):
        the final norm adds it."""
        x = self.embed_tokens(ids.long()).to(self.cfg.dtype)
        if self.embedding_multiplier != 1.0:
            x = x * self.embedding_multiplier
        delta = None
        for layer in self.layers:
            x, delta = layer(x, delta, ctx)
        return x, delta

    def _final_norm(self, x: torch.Tensor, delta: Optional[torch.Tensor],
                    ctx) -> torch.Tensor:
        return residual_norm(x, delta, getattr(self, self.norm_name), ctx.fused,
                             self.residual_multiplier)[1]

    def hidden(self, ids: torch.Tensor, mask: torch.Tensor, **kw) -> torch.Tensor:
        """Final-norm hidden states (B, L, hidden) in the compute dtype."""
        ctx = self._context(mask.bool(), **kw)
        return self._final_norm(*self._trunk(ids, ctx), ctx)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_word_embeddings:
            # Flax Embed.attend: query and table in the compute dtype
            dt = self.cfg.dtype
            out = F.linear(x.float().to(dt), self.embed_tokens.weight.to(dt))
        else:
            out = F.linear(x.float(), self.lm_head.weight.float())
        return out if self.logits_scaling == 1.0 else out / self.logits_scaling

    def last_logits(self, ids: torch.Tensor, mask: torch.Tensor, **kw) -> torch.Tensor:
        """Logits (B, V) at the last position only (rows left-padded): the
        yes/no readout projects one (B, hidden) slice, not (B, L, V)."""
        return self._logits(self.hidden(ids, mask, **kw)[:, -1, :])

    def last_logits_packed(self, ids: torch.Tensor, positions: torch.Tensor,
                           seg: torch.Tensor, last_index: torch.Tensor, **kw) -> torch.Tensor:
        """Logits (N, V) of N sequences packed several to a row
        (``models/packing.py``): ``ids``, ``positions`` (counted from each
        sequence's first token) and ``seg`` (each sequence's slot in its
        row, −1 on padding) are (R, L); ``last_index`` (N,) holds the flat
        ``row * L + column`` of each sequence's last token, and the logits
        come back in its order. Only those N hidden states go through the
        final norm and the vocabulary head."""
        ctx = self._packed_context(positions.long(), seg, **kw)
        x, delta = self._trunk(ids, ctx)
        return self._logits(self._final_norm(*last_rows(x, delta, last_index), ctx))

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Logits (B, L, V)."""
        return self._logits(self.hidden(ids, mask))
