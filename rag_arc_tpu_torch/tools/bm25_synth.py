"""Synthetic BM25 corpora and query profiles (the recipes of the JAX
package's ``tools/bm25_bench.py::synth_csr`` and
``bench.py::_bm25_queries``, copied: the port imports nothing of the
JAX package or its tools).

``synth_csr`` draws a zipf(1.3) corpus directly as CSR term-frequency
arrays, with no Python strings, so 2M documents synthesize in seconds.
Term ``i`` is the token ``"w{i}"``, the default vocabulary of
``DeviceBM25Index.build_from_csr``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def synth_csr(rng, n_docs: int, vocab: int = 50_000, mean_len: int = 60):
    """(row_offsets (n+1,) int64, term_ids int32, tfs f32, doc lengths
    int64) of a zipf corpus: each document draws its length uniformly
    from [mean_len/2, 3·mean_len/2) and its tokens from zipf(1.3) mod
    vocab; one CSR entry per distinct (doc, term) with its count."""
    lens = rng.integers(mean_len // 2, mean_len * 3 // 2, size=n_docs).astype(np.int64)
    total = int(lens.sum())
    ids = (rng.zipf(1.3, size=total) % vocab).astype(np.int64)
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
    key = doc_of * vocab + ids  # sortable (doc, term) pair
    del ids, doc_of
    uniq, counts = np.unique(key, return_counts=True)
    del key
    term_ids = (uniq % vocab).astype(np.int32)
    row_counts = np.bincount(uniq // vocab, minlength=n_docs)
    del uniq
    row_offsets = np.zeros(n_docs + 1, dtype=np.int64)
    np.cumsum(row_counts, out=row_offsets[1:])
    return row_offsets, term_ids, counts.astype(np.float32), lens


def bm25_queries(rng, n: int, vocab: int = 50_000) -> Tuple[List[List[str]], List[List[str]]]:
    """Two profiles of ``n`` tokenized queries: head (8 zipf draws each,
    stopword-heavy: the host scorer's worst case) and selective (8 terms
    uniform in [1000, vocab): informative tail terms)."""
    head = [[f"w{t}" for t in (rng.zipf(1.3, size=8) % vocab)] for _ in range(n)]
    sel = [[f"w{t}" for t in rng.integers(1_000, vocab, size=8)] for _ in range(n)]
    return head, sel


def mixed_queries(head: List[List[str]], sel: List[List[str]]) -> List[List[str]]:
    """The routed stream: 25% head / 62.5% selective / 12.5% zero-match
    (four unindexed tokens), by position i % 8."""
    out = []
    for i in range(len(head)):
        r = i % 8
        if r < 2:
            out.append(head[i])
        elif r == 7:
            out.append([f"zz_unindexed_{i}_{j}" for j in range(4)])
        else:
            out.append(sel[i])
    return out


def csr_texts(row_offsets, term_ids, tfs) -> List[str]:
    """The corpus as whitespace texts (each term repeated tf times), whose
    ``lower().split()`` tokenization gives the same term frequencies."""
    vocab = np.array([f"w{i}" for i in range(int(term_ids.max()) + 1)], dtype=object)
    tf = tfs.astype(np.int64)
    tokens = vocab[np.repeat(term_ids, tf)]
    at = np.concatenate([[0], np.cumsum(tf)])[row_offsets]  # token offset of each row
    return [" ".join(tokens[s:e]) for s, e in zip(at[:-1], at[1:])]
