"""Text chunkers.

The port's own copy of ``rag_arc_tpu/chunking/splitters.py``, its behaviour
unchanged, so the port imports nothing of the JAX package.

Capability parity with the reference's ``core/file_management/chunker/
spliter.py`` (SURVEY.md §2.7): markdown header splitting (code-fence
aware), fixed token windows with overlap, recursive character splitting
with a separator cascade, and embedding-based semantic chunking with
percentile / stddev / IQR / gradient breakpoint strategies.

TPU notes: the semantic chunker's embedding pass goes through the
``Embeddings`` interface, so with ``FlaxEncoderEmbeddings`` all sentence
embeddings for a document are computed in batched device dispatches;
the distance/threshold math is numpy (tiny).

The token splitter accepts any object with ``encode``/``decode``; tiktoken
is used when its BPE data is locally available (this image has no network
egress, so the default falls back to a reversible whitespace tokenizer).
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Literal, Optional, Sequence

import numpy as np

from rag_arc_tpu_torch.models.embeddings import Embeddings
from rag_arc_tpu_torch.utils.data_model import Document

logger = logging.getLogger(__name__)


# -- markdown header splitter ---------------------------------------------


@dataclass
class HeaderInfo:
    level: int
    name: str


class MarkdownHeaderTextSplitter:
    """Split markdown on ``#``-style headers, tracking the header path.

    Fence-aware: header-looking lines inside ``` or ~~~ blocks are body
    text. Produces one ``Document`` per section with metadata
    ``{"headers": {"H1": ..., "H2": ...}, "header_level": n}``.
    """

    def __init__(
        self,
        headers_to_split_on: Optional[Sequence[tuple[str, str]]] = None,
        strip_headers: bool = False,
        max_chars: Optional[int] = None,
        overlap: int = 0,
    ):
        # default: split on "#" and "##" (reference default)
        self.headers_to_split_on = sorted(
            headers_to_split_on or [("#", "H1"), ("##", "H2")],
            key=lambda p: -len(p[0]),  # longest prefix wins
        )
        self.strip_headers = strip_headers
        if max_chars is not None and overlap >= max_chars:
            # the sibling splitters raise for this; a silent stride-1
            # fallback shreds a 10k-char section into ~10k 99%-duplicate
            # chunks
            raise ValueError(
                f"overlap ({overlap}) must be smaller than max_chars "
                f"({max_chars})"
            )
        self.max_chars = max_chars
        self.overlap = overlap

    def _match_header(self, line: str) -> Optional[tuple[str, str, str]]:
        stripped = line.lstrip()
        for prefix, name in self.headers_to_split_on:
            if stripped.startswith(prefix + " ") or stripped == prefix:
                title = stripped[len(prefix):].strip()
                return prefix, name, title
        return None

    def split_text(self, text: str) -> List[Document]:
        lines = text.split("\n")
        sections: List[Document] = []
        header_stack: Dict[str, str] = {}
        current_level = 0
        buf: List[str] = []
        in_fence: Optional[str] = None

        def flush() -> None:
            content = "\n".join(buf).strip()
            if content:
                sections.append(
                    Document(
                        content=content,
                        metadata={
                            "headers": dict(header_stack),
                            "header_level": current_level,
                        },
                    )
                )
            buf.clear()

        for line in lines:
            fence = re.match(r"\s*(```|~~~)", line)
            if fence:
                token = fence.group(1)
                if in_fence is None:
                    in_fence = token
                elif in_fence == token:
                    in_fence = None
                buf.append(line)
                continue
            if in_fence is None:
                match = self._match_header(line)
                if match is not None:
                    prefix, name, title = match
                    flush()
                    level = len(prefix)
                    # pop deeper/equal headers off the stack
                    for p, n in self.headers_to_split_on:
                        if len(p) >= level:
                            header_stack.pop(n, None)
                    header_stack[name] = title
                    current_level = level
                    if not self.strip_headers:
                        buf.append(line)
                    continue
            buf.append(line)
        flush()

        if self.max_chars:
            sections = self._sub_chunk(sections)
        return sections

    def _sub_chunk(self, sections: List[Document]) -> List[Document]:
        out: List[Document] = []
        stride = max(1, self.max_chars - self.overlap)
        for doc in sections:
            if len(doc.content) <= self.max_chars:
                out.append(doc)
                continue
            for start in range(0, len(doc.content), stride):
                piece = doc.content[start : start + self.max_chars]
                if piece.strip():
                    out.append(
                        Document(content=piece, metadata=dict(doc.metadata))
                    )
                if start + self.max_chars >= len(doc.content):
                    break  # next window = strict suffix (duplicate chunk)
        return out

    def split_documents(self, docs: Iterable[Document]) -> List[Document]:
        out = []
        for d in docs:
            for piece in self.split_text(d.content):
                piece.metadata = {**d.metadata, **piece.metadata}
                out.append(piece)
        return out


# -- token splitter --------------------------------------------------------


class _WhitespaceTokenizerFallback:
    """Reversible whitespace tokenization (used when tiktoken's BPE data
    is not on disk — this image cannot download it)."""

    def encode(self, text: str) -> List[str]:
        return re.findall(r"\S+\s*", text)

    def decode(self, tokens: Sequence[str]) -> str:
        return "".join(tokens)


def _resolve_tokenizer(encoding_name: str):
    try:
        import tiktoken

        return tiktoken.get_encoding(encoding_name)
    except Exception:  # noqa: BLE001 — no BPE data / no tiktoken
        logger.info(
            "tiktoken encoding %r unavailable; using whitespace fallback",
            encoding_name,
        )
        return _WhitespaceTokenizerFallback()


class TokenTextSplitter:
    """Fixed token windows with overlap stride (ref spliter.py:139-204)."""

    def __init__(
        self,
        tokens_per_chunk: int = 256,
        chunk_overlap: int = 32,
        encoding_name: str = "cl100k_base",
        tokenizer: Any = None,
    ):
        if chunk_overlap >= tokens_per_chunk:
            raise ValueError("chunk_overlap must be smaller than tokens_per_chunk")
        self.tokens_per_chunk = tokens_per_chunk
        self.chunk_overlap = chunk_overlap
        self.tokenizer = tokenizer or _resolve_tokenizer(encoding_name)

    def split_text(self, text: str) -> List[str]:
        tokens = self.tokenizer.encode(text)
        if not tokens:
            return []
        stride = self.tokens_per_chunk - self.chunk_overlap
        chunks = []
        for start in range(0, len(tokens), stride):
            window = tokens[start : start + self.tokens_per_chunk]
            chunks.append(self.tokenizer.decode(window))
            if start + self.tokens_per_chunk >= len(tokens):
                break
        return chunks

    def split_documents(self, docs: Iterable[Document]) -> List[Document]:
        out = []
        for d in docs:
            for i, piece in enumerate(self.split_text(d.content)):
                out.append(
                    Document(
                        content=piece, metadata={**d.metadata, "chunk_index": i}
                    )
                )
        return out


# -- recursive character splitter -----------------------------------------


class RecursiveCharacterTextSplitter:
    """Separator-cascade splitting (ref spliter.py:207-293).

    Tries each separator in order; pieces still over ``chunk_size`` recurse
    into the next separator; the final fallback is hard fixed windows with
    ``chunk_overlap``. ``keep_separator`` ∈ {False, "start", "end"}.
    """

    def __init__(
        self,
        chunk_size: int = 1000,
        chunk_overlap: int = 100,
        separators: Optional[Sequence[str]] = None,
        is_separator_regex: bool = False,
        keep_separator: bool | Literal["start", "end"] = "start",
    ):
        if chunk_overlap >= chunk_size:
            raise ValueError("chunk_overlap must be smaller than chunk_size")
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.separators = list(separators or ["\n\n", "\n", "#"])
        self.is_separator_regex = is_separator_regex
        self.keep_separator = keep_separator

    def _split_on(self, text: str, separator: str) -> List[str]:
        pattern = separator if self.is_separator_regex else re.escape(separator)
        if not pattern:
            return list(text)
        if self.keep_separator:
            pieces = re.split(f"({pattern})", text)
            merged: List[str] = []
            if self.keep_separator == "end":
                for i in range(0, len(pieces), 2):
                    body = pieces[i] + (pieces[i + 1] if i + 1 < len(pieces) else "")
                    merged.append(body)
            else:  # "start" / True
                i = 0
                if pieces and pieces[0]:
                    merged.append(pieces[0])
                for j in range(1, len(pieces), 2):
                    merged.append(pieces[j] + (pieces[j + 1] if j + 1 < len(pieces) else ""))
            return [m for m in merged if m]
        return [p for p in re.split(pattern, text) if p]

    def _hard_split(self, text: str) -> List[str]:
        stride = self.chunk_size - self.chunk_overlap
        out: List[str] = []
        for i in range(0, len(text), stride):
            piece = text[i : i + self.chunk_size]
            if piece:
                out.append(piece)
            if i + self.chunk_size >= len(text):
                # the next window would be a strict SUFFIX of this one
                # (tail shorter than the overlap) — a pure-duplicate chunk
                break
        return out

    def _recurse(self, text: str, separators: Sequence[str]) -> List[str]:
        if len(text) <= self.chunk_size:
            return [text] if text else []
        if not separators:
            return self._hard_split(text)
        pieces = self._split_on(text, separators[0])
        if len(pieces) == 1:
            return self._recurse(text, separators[1:])
        out: List[str] = []
        acc = ""
        for piece in pieces:
            if len(acc) + len(piece) <= self.chunk_size:
                acc += piece
                continue
            if acc:
                out.append(acc)
                acc = ""
            if len(piece) <= self.chunk_size:
                acc = piece
            else:
                out.extend(self._recurse(piece, separators[1:]))
        if acc:
            out.append(acc)
        return out

    def split_text(self, text: str) -> List[str]:
        return [c for c in self._recurse(text, self.separators) if c.strip()]

    def split_documents(self, docs: Iterable[Document]) -> List[Document]:
        out = []
        for d in docs:
            for i, piece in enumerate(self.split_text(d.content)):
                out.append(
                    Document(content=piece, metadata={**d.metadata, "chunk_index": i})
                )
        return out


# -- semantic chunker ------------------------------------------------------

BREAKPOINT_DEFAULTS: Dict[str, float] = {
    "percentile": 95.0,
    "standard_deviation": 3.0,
    "interquartile": 1.5,
    "gradient": 95.0,
}

_SENTENCE_RE = re.compile(r"(?<=[.?!。？！])\s+")


class SemanticChunker:
    """Embedding-distance-based chunk boundaries (ref spliter.py:296-526).

    Sentences are buffered with ``buffer_size`` neighbors, embedded (one
    batched device dispatch via the Embeddings interface), and consecutive
    cosine distances are thresholded by the chosen strategy — or, when
    ``number_of_chunks`` is given, by interpolating the percentile that
    yields that many chunks.
    """

    def __init__(
        self,
        embeddings: Embeddings,
        buffer_size: int = 1,
        breakpoint_threshold_type: str = "percentile",
        breakpoint_threshold_amount: Optional[float] = None,
        number_of_chunks: Optional[int] = None,
        min_chunk_size: Optional[int] = None,
        sentence_split_regex: str | re.Pattern = _SENTENCE_RE,
    ):
        if breakpoint_threshold_type not in BREAKPOINT_DEFAULTS:
            raise ValueError(
                f"breakpoint_threshold_type must be one of "
                f"{sorted(BREAKPOINT_DEFAULTS)}, got {breakpoint_threshold_type!r}"
            )
        self.embeddings = embeddings
        self.buffer_size = buffer_size
        self.threshold_type = breakpoint_threshold_type
        self.threshold_amount = (
            BREAKPOINT_DEFAULTS[breakpoint_threshold_type]
            if breakpoint_threshold_amount is None
            else breakpoint_threshold_amount
        )
        self.number_of_chunks = number_of_chunks
        self.min_chunk_size = min_chunk_size
        self.sentence_re = (
            re.compile(sentence_split_regex)
            if isinstance(sentence_split_regex, str)
            else sentence_split_regex
        )

    # -- pipeline ---------------------------------------------------------

    def _split_sentences(self, text: str) -> List[str]:
        return [s for s in self.sentence_re.split(text) if s.strip()]

    def _combine_sentences(self, sentences: List[str]) -> List[str]:
        combined = []
        for i in range(len(sentences)):
            lo = max(0, i - self.buffer_size)
            hi = min(len(sentences), i + self.buffer_size + 1)
            combined.append(" ".join(sentences[lo:hi]))
        return combined

    def _distances(self, combined: List[str]) -> np.ndarray:
        vecs = self.embeddings.encode(combined)
        norms = np.linalg.norm(vecs, axis=1, keepdims=True)
        unit = vecs / np.maximum(norms, 1e-12)
        sims = np.sum(unit[:-1] * unit[1:], axis=1)
        return 1.0 - sims

    def _threshold(self, distances: np.ndarray) -> float:
        t = self.threshold_type
        amount = self.threshold_amount
        if self.number_of_chunks is not None:
            return self._threshold_from_chunk_count(distances)
        if t == "percentile":
            return float(np.percentile(distances, amount))
        if t == "standard_deviation":
            return float(distances.mean() + amount * distances.std())
        if t == "interquartile":
            q1, q3 = np.percentile(distances, [25, 75])
            return float(distances.mean() + amount * (q3 - q1))
        # gradient: threshold on the slope of the distance curve
        grad = np.gradient(distances)
        return float(np.percentile(grad, amount))

    def _threshold_from_chunk_count(self, distances: np.ndarray) -> float:
        """Interpolate the percentile yielding ~number_of_chunks chunks
        (ref spliter.py:434-452): x = #chunks maps linearly from
        (len, 1.0) → (1, 100.0)."""
        x1, y1 = float(len(distances)), 0.0
        x2, y2 = 1.0, 100.0
        x = max(min(float(self.number_of_chunks), x1), x2)
        y = y1 + (y2 - y1) * (x - x1) / (x2 - x1) if x2 != x1 else y2
        y = min(max(y, 0.0), 100.0)
        return float(np.percentile(distances, y))

    def split_text(self, text: str) -> List[str]:
        sentences = self._split_sentences(text)
        if len(sentences) <= 1:
            return [text] if text.strip() else []
        if self.threshold_type == "gradient" and len(sentences) == 2:
            return [" ".join(sentences)]
        combined = self._combine_sentences(sentences)
        distances = self._distances(combined)
        threshold = self._threshold(distances)
        if self.threshold_type == "gradient" and self.number_of_chunks is None:
            over = np.gradient(distances) > threshold
        else:
            # number_of_chunks interpolates a percentile of DISTANCES, so
            # the comparison must run in the same domain even under
            # gradient mode — comparing gradients (~0-centered) against a
            # distance percentile ignored the requested chunk count
            over = distances > threshold
        breakpoints = [i for i, flag in enumerate(over) if flag]

        chunks: List[str] = []
        start = 0
        for bp in breakpoints:
            chunk = " ".join(sentences[start : bp + 1]).strip()
            if chunk and (
                self.min_chunk_size is None or len(chunk) >= self.min_chunk_size
            ):
                chunks.append(chunk)
                start = bp + 1
        tail = " ".join(sentences[start:]).strip()
        if tail:
            chunks.append(tail)
        return chunks

    def split_documents(self, docs: Iterable[Document]) -> List[Document]:
        out = []
        for d in docs:
            for i, piece in enumerate(self.split_text(d.content)):
                out.append(
                    Document(content=piece, metadata={**d.metadata, "chunk_index": i})
                )
        return out
