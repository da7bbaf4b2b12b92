"""Pointwise yes/no cross-encoder reranker (counterpart of
``rag_arc_tpu/rerank/cross_encoder.py``).

Each (query, document) pair is rendered into a judge prompt, tokenized
with left padding, run through a causal LM, and scored as P("yes") from
a two-way log-softmax over the "yes"/"no" logits at the last position;
results sort descending (stable) and truncate to k. The whole candidate
set — for ``rerank_batch`` every query's — is one left-padded (N, L)
batch, cut into chunks only at ``ATTN_BYTES_BUDGET``, with one readback
at the end. Batches are not padded to a power of two: a pair's score
does not depend on what it is batched with.

The scorer is the default ``CausalLM`` (``models/encoder.py``) or any
model with ``last_logits`` — ``Qwen3LM`` (``models/qwen3.py``), whose
attention runs the ``rope_prep`` and flash-attention kernels on the card.

Spans (``utils/tracing.py``): ``rerank.prompts`` (rendering and the
bucketed tokenization, with ``tokens``, the real prompt tokens, and
``slots``, the token slots the forward runs), ``rerank.forward`` (the
chunks' uploads and launches) and ``rerank.readback``, each with ``pairs``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from rag_arc_tpu_torch.models.tokenizer import HashTokenizer
from rag_arc_tpu_torch.utils.data_model import Document
from rag_arc_tpu_torch.models.encoder import CausalLM, TransformerConfig, init_causal_lm
from rag_arc_tpu_torch.rerank.base import RerankerBase
from rag_arc_tpu_torch.utils.tracing import stage

# copied letter for letter from rag_arc_tpu/rerank/cross_encoder.py, whose
# module imports JAX
DEFAULT_INSTRUCTION = (
    "Given a web search query, retrieve relevant passages that answer the query"
)

PROMPT_TEMPLATE = (
    "Judge whether the Document meets the requirements based on the Query "
    "and the Instruct provided. Answer only \"yes\" or \"no\".\n"
    "<Instruct>: {instruction}\n<Query>: {query}\n<Document>: {document}\n"
    "Answer:"
)


def _score_batch(
    model, ids: torch.Tensor, mask: torch.Tensor, yes_id: int, no_id: int
) -> torch.Tensor:
    """(B,) f32 P(yes) per row: a two-way log-softmax over the no/yes
    logits at the last position (rows left-padded). Only the last hidden
    state goes through the vocabulary head."""
    if hasattr(model, "last_logits"):
        last = model.last_logits(ids, mask)
    elif isinstance(model, CausalLM):
        last = model(ids, mask, True)
    else:
        last = model(ids, mask)[:, -1, :]  # (B, V)
    pair = torch.stack([last[:, no_id], last[:, yes_id]], dim=-1).float()
    return torch.exp(torch.log_softmax(pair, dim=-1)[:, 1])


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


class CrossEncoderReranker(RerankerBase):
    _LEN_BUCKETS = (64, 128, 256, 512)

    # device byte budget for one chunk's einsum-attention probabilities
    # (B, heads, L, L) f32; chunks dispatch back to back and come back in
    # one readback
    ATTN_BYTES_BUDGET = 2 << 30

    def __init__(
        self,
        cfg: Optional[TransformerConfig] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
        tokenizer=None,
        instruction: str = DEFAULT_INSTRUCTION,
        max_length: int = 512,
        seed: int = 0,
        *,
        device: torch.device | str,
    ):
        """The default scorer: a ``CausalLM`` over ``cfg`` (768×12 causal by
        default) with seeded random weights, or ``params`` (its state_dict,
        e.g. from ``models.convert.causal_lm_state_dict_from_flax``)."""
        self.cfg = cfg or TransformerConfig(causal=True)
        self.device = torch.device(device)
        self.model = init_causal_lm(self.cfg, seed, self.device)
        if params is not None:
            self.model.load_state_dict(params)
        self.tokenizer = tokenizer or HashTokenizer(
            vocab_size=self.cfg.vocab_size, max_len=min(max_length, self.cfg.max_len)
        )
        self.instruction = instruction
        self.max_length = min(max_length, self.cfg.max_len)
        self.yes_id = self.tokenizer.token_id("yes")
        self.no_id = self.tokenizer.token_id("no")

    @classmethod
    def from_causal_lm(
        cls,
        model,
        params: Optional[Dict[str, torch.Tensor]],
        tokenizer,
        instruction: str = DEFAULT_INSTRUCTION,
        max_length: int = 512,
        yes_token: str = "yes",
        no_token: str = "no",
        *,
        device: torch.device | str | None = None,
    ) -> "CrossEncoderReranker":
        """Build over any causal LM module with ``last_logits(ids, mask)`` or
        a ``(B, L, V)`` forward — e.g. a ``Qwen3LM`` from
        ``models.qwen3.load_hf_qwen3``. ``params``, when given, is a
        state_dict loaded into ``model``; ``device`` is the model's (given
        or read from its parameters)."""
        self = cls.__new__(cls)
        self.device = _model_device(model) if device is None else torch.device(device)
        if _model_device(model) != self.device:
            raise ValueError(
                f"model lives on {_model_device(model)}, not on {self.device}"
            )
        if params is not None:
            model.load_state_dict(params)
        self.cfg = getattr(model, "cfg", None)
        self.model = model
        self.tokenizer = tokenizer
        self.instruction = instruction
        self.max_length = max_length
        self.yes_id = tokenizer.token_id(yes_token) if hasattr(
            tokenizer, "token_id"
        ) else tokenizer.convert_tokens_to_ids(yes_token)
        self.no_id = tokenizer.token_id(no_token) if hasattr(
            tokenizer, "token_id"
        ) else tokenizer.convert_tokens_to_ids(no_token)
        return self

    def _encode_bucketed(self, prompts: Sequence[str]):
        """Tokenize once, then pad the batch on the left to the smallest
        length bucket that fits, or keep the tail of a longer one."""
        ids, mask = self.tokenizer.batch_encode(prompts, left_pad=True)
        needed = ids.shape[1]
        bucket = next(
            (b for b in self._LEN_BUCKETS if needed <= b <= self.max_length),
            self.max_length,
        )
        if bucket > needed:
            pad = bucket - needed
            ids = np.pad(ids, ((0, 0), (pad, 0)))
            mask = np.pad(mask, ((0, 0), (pad, 0)))
        elif bucket < needed:
            # keep the tail: real tokens sit at the end under left padding
            ids = ids[:, -bucket:]
            mask = mask[:, -bucket:]
        return ids, mask

    def _render(self, query: str, document: str) -> str:
        return PROMPT_TEMPLATE.format(
            instruction=self.instruction, query=query, document=document
        )

    @torch.inference_mode()
    def _score_prompts(self, prompts: Iterable[str]) -> np.ndarray:
        """Render (``prompts`` may be a lazy iterable) and encode → chunk at
        the attention byte budget → dispatch every chunk → one readback.
        The single scoring path of both entry points."""
        with stage("rerank.prompts") as span:
            prompts = list(prompts)
            ids, mask = self._encode_bucketed(prompts)
            span["pairs"], span["tokens"], span["slots"] = len(prompts), int(mask.sum()), ids.size
        n, length = len(prompts), ids.shape[1]
        heads = (
            getattr(self.cfg, "heads", None)
            or getattr(self.cfg, "num_attention_heads", None)
            or 16
        )
        max_chunk = max(64, self.ATTN_BYTES_BUDGET // (heads * length * length * 4))
        max_chunk = 1 << int(math.floor(math.log2(max_chunk)))
        with stage("rerank.forward", pairs=n):
            ids_d = torch.from_numpy(np.ascontiguousarray(ids)).to(self.device)
            mask_d = torch.from_numpy(np.ascontiguousarray(mask)).to(self.device)
            pending = [
                _score_batch(self.model, ids_d[lo : lo + max_chunk],
                             mask_d[lo : lo + max_chunk], self.yes_id, self.no_id)
                for lo in range(0, n, max_chunk)
            ]
        with stage("rerank.readback", pairs=n):
            return torch.cat(pending).cpu().numpy()

    def compute_scores(self, query: str, documents: Sequence[Document]) -> np.ndarray:
        """P(yes) of every candidate, in one scoring pass."""
        if not documents:
            return np.empty((0,), dtype=np.float32)
        return self._score_prompts(self._render(query, d.content) for d in documents)

    def rerank(
        self, query: str, documents: Sequence[Document], k: Optional[int] = None, **_: Any
    ) -> List[Document]:
        documents = list(documents)
        scores = self.compute_scores(query, documents)
        return self._sorted(documents, scores, k)

    def rerank_batch(
        self,
        queries: Sequence[str],
        documents_per_query: Sequence[Sequence[Document]],
        k: Optional[int] = None,
    ) -> List[List[Document]]:
        """Rerank many queries' candidate sets in one scoring pass: every
        (query, document) pair goes into one left-padded batch."""
        if len(queries) != len(documents_per_query):
            raise ValueError("queries and candidate lists length mismatch")
        spans: List[tuple[int, int]] = []
        n = 0
        for docs in documents_per_query:
            spans.append((n, n + len(docs)))
            n += len(docs)
        if not n:
            return [[] for _ in queries]
        # rendered lazily, inside the rerank.prompts span
        scores = self._score_prompts(
            self._render(query, doc.content)
            for query, docs in zip(queries, documents_per_query)
            for doc in docs
        )
        return [
            self._sorted(list(docs), scores[lo:hi], k)
            for (lo, hi), docs in zip(spans, documents_per_query)
        ]

    def _sorted(
        self, documents: List[Document], scores: np.ndarray, k: Optional[int]
    ) -> List[Document]:
        """Stable descending order, truncated to k; the score is stamped on
        a copy of each Document (the docstore hands out shared instances)."""
        order = np.argsort(-scores, kind="stable")
        k = len(documents) if k is None else int(k)
        out = []
        for i in order[:k]:
            doc = documents[int(i)]
            out.append(
                Document(
                    content=doc.content,
                    metadata={**doc.metadata, "rerank_score": float(scores[int(i)])},
                    id=doc.id,
                )
            )
        return out
