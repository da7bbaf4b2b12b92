"""Tokenizers for the JAX model stack.

The port's own copy of ``rag_arc_tpu/models/tokenizer.py``, its behaviour unchanged, so
the port imports nothing of the JAX package.

The reference delegates tokenization to HuggingFace tokenizers downloaded
at runtime (``huggingface.py``, ``Reranker_Qwen3.py:29-39``). This
environment is zero-egress, so the default here is a **hashing tokenizer**:
words/punctuation are hashed into a fixed id space (the classic hashing
trick). It is deterministic, vocabulary-free, language-agnostic, and good
enough to exercise and benchmark every model path; production deployments
swap in a real vocabulary through the same interface (``HFTokenizerAdapter``
wraps any ``transformers`` tokenizer when one is locally available).
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
UNK_ID = 3
N_SPECIAL = 4


class HashTokenizer:
    """Deterministic vocabulary-free tokenizer."""

    _TOKEN_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)

    # the token→id cache lives for the embedder/server's lifetime; a 10M-doc
    # ingest (or adversarial random strings) would grow it without bound —
    # past the cap, ids are computed without caching (hot tokens are cached
    # early, so the speedup survives)
    _CACHE_CAP = 1 << 18

    def __init__(self, vocab_size: int = 32768, max_len: int = 512):
        if vocab_size <= N_SPECIAL:
            raise ValueError("vocab_size must exceed the special-token count")
        self.vocab_size = vocab_size
        self.max_len = max_len
        self._cache: dict[str, int] = {}

    def token_id(self, token: str) -> int:
        tid = self._cache.get(token)
        if tid is None:
            h = int.from_bytes(hashlib.md5(token.encode("utf-8")).digest()[:8], "little")
            tid = N_SPECIAL + h % (self.vocab_size - N_SPECIAL)
            if len(self._cache) < self._CACHE_CAP:
                self._cache[token] = tid
        return tid

    def encode(
        self, text: str, add_special: bool = True, keep: str = "head"
    ) -> List[int]:
        """``keep`` picks which end survives truncation: documents keep the
        head; last-position readers (the cross-encoder's '\\nAnswer:' cue)
        must keep the tail or the cue itself is the first thing cut."""
        ids = [self.token_id(t) for t in self._TOKEN_RE.findall(text.lower())]
        if add_special:
            body = ids[: self.max_len - 2] if keep == "head" else ids[-(self.max_len - 2):]
            ids = [BOS_ID] + body + [EOS_ID]
        else:
            ids = ids[: self.max_len] if keep == "head" else ids[-self.max_len:]
        return ids

    def batch_encode(
        self,
        texts: Sequence[str],
        pad_to: Optional[int] = None,
        left_pad: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (ids (B, L) int32, mask (B, L) bool). ``left_pad`` matches
        causal-LM scoring (the reranker reads last-position logits, so real
        tokens must sit at the end — reference Reranker_Qwen3.py:29-39 uses
        left padding for the same reason)."""
        keep = "tail" if left_pad else "head"
        encoded = [self.encode(t, keep=keep) for t in texts]
        longest = max((len(e) for e in encoded), default=1)
        length = min(pad_to or longest, self.max_len)
        length = max(length, 1)
        ids = np.full((len(texts), length), PAD_ID, dtype=np.int32)
        mask = np.zeros((len(texts), length), dtype=bool)
        for i, e in enumerate(encoded):
            # left-pad callers read LAST-position logits: truncation keeps
            # the tail end-to-end, so the prompt's answer cue survives
            e = e[-length:] if left_pad else e[:length]
            if left_pad:
                ids[i, length - len(e):] = e
                mask[i, length - len(e):] = True
            else:
                ids[i, : len(e)] = e
                mask[i, : len(e)] = True
        return ids, mask


class HFTokenizerAdapter:
    """Adapter presenting a local ``transformers`` tokenizer through the
    same batch_encode interface (gated: only usable when weights/vocab
    exist on disk — this image has no network egress)."""

    def __init__(self, tokenizer, max_len: int = 512):
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.vocab_size = int(tokenizer.vocab_size)

    def batch_encode(self, texts, pad_to=None, left_pad=False):
        # save/restore: the wrapped tokenizer may be shared with other
        # components (qwen3 generate pads left, bert pads right) — a
        # permanent flip here would silently change THEIR padding. And
        # left-pad callers read last-position logits, so truncation must
        # keep the tail (HF truncates right by default).
        saved = (self.tokenizer.padding_side, self.tokenizer.truncation_side)
        try:
            self.tokenizer.padding_side = "left" if left_pad else "right"
            self.tokenizer.truncation_side = "left" if left_pad else "right"
            out = self.tokenizer(
                list(texts),
                padding="max_length" if pad_to else True,
                max_length=pad_to or self.max_len,
                truncation=True,
                return_tensors="np",
            )
        finally:
            self.tokenizer.padding_side, self.tokenizer.truncation_side = saved
        return out["input_ids"].astype(np.int32), out["attention_mask"].astype(bool)
