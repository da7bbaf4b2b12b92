"""Pointwise yes/no cross-encoder reranker (counterpart of
``rag_arc_tpu/rerank/cross_encoder.py``).

Each (query, document) pair is rendered into a judge prompt, tokenized
once as a left-padded batch (``_encode_bucketed``: as wide as the longest
prompt, the tail of a prompt longer than ``max_length`` kept), its real
tokens packed first-fit-decreasing into rows of ``max_length`` tokens
(``pack_prompts``; several pairs a row, padding only at the ends of rows),
run through a causal LM, and scored as P("yes") from a two-way
log-softmax over the "yes"/"no" logits at the pair's last token; results
sort descending (stable) and truncate to k. Each pair sees only its own
tokens and counts its positions from its first token. The whole
candidate set — for ``rerank_batch`` every query's — is one scoring pass,
cut into chunks of rows only at ``ATTN_BYTES_BUDGET``, with one readback
at the end; scores come back in the pairs' order.

The scorer's one contract is ``last_logits_packed(ids, positions, seg,
last_index, **kw) -> (N, V)`` (``models/decoder.py``'s ``DecoderLM``:
``Qwen3LM``, ``models/qwen3.py``, whose attention masks by segment ids,
and ``Lfm2MoeLM``, ``models/lfm2_moe.py``, whose short convolutions also
stop at segment starts; the default ``CausalLM``, ``models/encoder.py``,
with a causal same-segment bias). A model without it is refused.

Batches are not padded to a power of two: a pair's score does not depend
on what it is packed with. On the card ``Qwen3LM`` runs the
``rope_prep`` and flash-attention kernels, ``Lfm2MoeLM`` those and its
short-conv and expert kernels.

Spans (``utils/tracing.py``): ``rerank.prompts`` (rendering, the
tokenization and the packing, with ``tokens``, the real prompt tokens,
``slots``, the token slots the forward runs, and ``rows``),
``rerank.forward`` (the chunks' uploads and launches) and
``rerank.readback``, each with ``pairs``. A scorer that names
``device_counts`` (``Lfm2MoeLM`` and ``GraniteHybridLM``:
``moe_assignments``, ``moe_held``, ``moe_busiest``) sums them on the card
during the forward; they come back in the
readback's one copy and are set on the ``rerank.forward`` span's counts
then, after it closed (``/stats`` reads them from the same dict).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rag_arc_tpu_torch.models.tokenizer import HashTokenizer
from rag_arc_tpu_torch.utils.data_model import Document
from rag_arc_tpu_torch.models.encoder import TransformerConfig, init_causal_lm
from rag_arc_tpu_torch.models.packing import pack_token_lists
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


def _p_yes(last: torch.Tensor, yes_id: int, no_id: int) -> torch.Tensor:
    """(B,) f32 P(yes): a two-way log-softmax over the no/yes logits."""
    pair = torch.stack([last[:, no_id], last[:, yes_id]], dim=-1).float()
    return torch.exp(torch.log_softmax(pair, dim=-1)[:, 1])


def pack_prompts(
    ids: np.ndarray, mask: np.ndarray, row_len: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Left-padded prompts (N, L), none longer than ``row_len`` → their
    real tokens packed first-fit-decreasing into rows of ``row_len``
    (``models/packing.py``): ``(rows (3, R, row_len) int32 — ids,
    positions, segment ids (−1 on padding) —, row (N,), last (N,))``, with
    ``last`` the flat ``row * row_len + column`` of each prompt's last
    token. Padding sits only at the ends of rows."""
    lens = mask.sum(axis=1)
    tokens = [r[r.size - n:] for r, n in zip(ids, lens)]
    p_ids, pos, seg, mapping = pack_token_lists(tokens, row_len=row_len, max_segments=row_len)
    row, slot = np.array(mapping, dtype=np.int64).T
    width = np.zeros((p_ids.shape[0], slot.max() + 1), dtype=np.int64)
    width[row, slot] = lens
    last = row * row_len + np.cumsum(width, axis=1)[row, slot] - 1
    return np.stack([p_ids, pos, seg]), row, last


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


class CrossEncoderReranker(RerankerBase):
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
        cfg = cfg or TransformerConfig(causal=True)
        max_length = min(max_length, cfg.max_len)
        self._bind(init_causal_lm(cfg, seed, torch.device(device)), params,
                   tokenizer or HashTokenizer(vocab_size=cfg.vocab_size, max_len=max_length),
                   instruction, max_length, "yes", "no", None)

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
        """Build over a causal LM module with ``last_logits_packed`` — e.g.
        a ``Qwen3LM`` from ``models.qwen3.load_hf_qwen3`` or an
        ``Lfm2MoeLM`` from ``models.lfm2_moe.load_hf_lfm2_moe``. ``params``,
        when given, is a state_dict loaded into ``model``; ``device`` is the
        model's (given or read from its parameters)."""
        self = cls.__new__(cls)
        self._bind(model, params, tokenizer, instruction, max_length, yes_token, no_token,
                   device)
        return self

    def _bind(self, model, params, tokenizer, instruction, max_length, yes_token, no_token,
              device) -> None:
        if not hasattr(model, "last_logits_packed"):
            raise TypeError(f"{type(model).__name__} has no last_logits_packed, the "
                            "reranker's scoring contract")
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
        token_id = getattr(tokenizer, "token_id", None) or tokenizer.convert_tokens_to_ids
        self.yes_id, self.no_id = token_id(yes_token), token_id(no_token)

    def _encode_bucketed(self, prompts: Sequence[str]):
        """Tokenize once: ``(ids, mask)`` (N, L), left-padded to the longest
        prompt, the tail of one longer than ``max_length`` kept (real tokens
        sit at the end under left padding)."""
        ids, mask = self.tokenizer.batch_encode(prompts, left_pad=True)
        return ids[:, -self.max_length:], mask[:, -self.max_length:]

    def _render(self, query: str, document: str) -> str:
        return PROMPT_TEMPLATE.format(
            instruction=self.instruction, query=query, document=document
        )

    def _max_chunk(self, length: int) -> int:
        """Rows a chunk of ``length``-token rows takes under the budget."""
        heads = (
            getattr(self.cfg, "heads", None)
            or getattr(self.cfg, "num_attention_heads", None)
            or 16
        )
        max_chunk = max(64, self.ATTN_BYTES_BUDGET // (heads * length * length * 4))
        return 1 << int(math.floor(math.log2(max_chunk)))

    @torch.inference_mode()
    def _score_prompts(self, prompts: Iterable[str]) -> np.ndarray:
        """Render (``prompts`` may be a lazy iterable) and encode → pack →
        chunk at the attention byte budget → dispatch every chunk → one
        readback. The single scoring path of both entry points."""
        with stage("rerank.prompts") as span:
            prompts = list(prompts)
            ids, mask = self._encode_bucketed(prompts)
            rows, row_of, last = pack_prompts(ids, mask, self.max_length)
            n_rows, length = rows.shape[1:]
            span.update(pairs=len(prompts), tokens=int(mask.sum()), slots=n_rows * length,
                        rows=n_rows)
        n, max_chunk = len(prompts), self._max_chunk(length)
        # a pair never spans two rows, so a chunk of rows holds whole pairs:
        # in row order, each chunk's pairs are one run of ``order``
        order = np.argsort(row_of, kind="stable")
        ends = np.searchsorted(row_of[order], np.arange(max_chunk, n_rows + max_chunk, max_chunk))
        local = last[order] - (row_of[order] // max_chunk) * (max_chunk * length)
        names = getattr(self.model, "device_counts", ())
        kw = {}
        with stage("rerank.forward", pairs=n) as forward_span:
            rows_d = torch.from_numpy(rows).to(self.device)
            local_d = torch.from_numpy(local).to(self.device)
            if names:
                kw["counts"] = torch.zeros(len(names), dtype=torch.int64, device=self.device)
            pending, start = [], 0
            for lo, end in zip(range(0, n_rows, max_chunk), ends):
                ids_c, pos_c, seg_c = rows_d[:, lo : lo + max_chunk]
                logits = self.model.last_logits_packed(ids_c, pos_c, seg_c, local_d[start:end],
                                                       **kw)
                pending.append(_p_yes(logits, self.yes_id, self.no_id))
                start = end
        with stage("rerank.readback", pairs=n):
            out = torch.cat(pending)
            if names:  # one copy: the f32 scores and the counts, exact in f64
                out = torch.cat([out.double(), kw["counts"].double()])
            host = out.cpu().numpy()
            forward_span.update((k, int(v)) for k, v in zip(names, host[n:]))
            scores = np.empty(n, dtype=np.float32)
            scores[order] = host[:n]
            return scores

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
        (query, document) pair goes into one batch."""
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
