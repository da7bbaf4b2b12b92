"""Everything a run feeds the system, made from seeds.

The corpus (passage texts and their vectors) stands for a fixed public
dataset, so it is made from the configuration's ``corpus_seed`` and is the
same in every run; queries, their lengths and their arrival times come
from the run's ``--seed``. Texts are words of ``WORD_LETTERS`` lowercase
letters drawn from a fixed vocabulary, so a passage of n words is
``(WORD_LETTERS + 1) * n - 1`` bytes and the hash tokenizer reads it as
n tokens.

Lengths follow a lognormal with the source's mean, capped; a request
stream takes its lengths at stratified quantiles of that law, shuffled by
the seed, so every seed sends the same multiset of lengths in another
order.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import List, Sequence

import numpy as np

WORD_LETTERS = 5
VOCAB_WORDS = 30_000
VOCAB_SEED = 0x5EED_0C0B
TEXT_CHUNK = 8192  # passages a text chunk; each chunk has its own stream
VECTOR_BLOCK = 131_072  # corpus rows a vector block; each block its own stream


def subseed(*parts: int) -> int:
    """A 63-bit seed derived from any integers (negative and large ones too)."""
    words = [int(p) % (1 << 64) for p in parts]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def _vocab_table() -> np.ndarray:
    """(VOCAB_WORDS, WORD_LETTERS + 1) bytes: each word and a trailing space."""
    rng = np.random.default_rng(VOCAB_SEED)
    table = np.full((VOCAB_WORDS, WORD_LETTERS + 1), ord(" "), dtype=np.uint8)
    table[:, :WORD_LETTERS] = rng.integers(ord("a"), ord("z") + 1,
                                           (VOCAB_WORDS, WORD_LETTERS), dtype=np.uint8)
    return table


_VOCAB = _vocab_table()


def lognormal_mu(mean: float, sigma: float) -> float:
    return math.log(mean) - sigma * sigma / 2.0


def draw_lengths(rng: np.random.Generator, n: int, law: dict) -> np.ndarray:
    """n independent word counts from ``law`` ({mean, sigma, cap})."""
    x = rng.lognormal(lognormal_mu(law["mean"], law["sigma"]), law["sigma"], n)
    return np.clip(np.rint(x), 1, law["cap"]).astype(np.int64)


def stratified_lengths(rng: np.random.Generator, n: int, law: dict) -> np.ndarray:
    """n word counts at the law's quantiles (i + 1/2) / n, in a seeded order."""
    mu, sigma = lognormal_mu(law["mean"], law["sigma"]), law["sigma"]
    nd = NormalDist()
    x = np.exp(mu + sigma * np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)]))
    lengths = np.clip(np.rint(x), 1, law["cap"]).astype(np.int64)
    return lengths[rng.permutation(n)]


def texts_from_words(words: np.ndarray, lengths: np.ndarray) -> List[str]:
    """Split a flat array of word ids into texts of the given word counts."""
    if len(lengths) == 0:
        return []
    rows = _VOCAB[words]  # (W, WORD_LETTERS + 1)
    ends = np.cumsum(lengths) - 1
    rows[ends, WORD_LETTERS] = ord("\n")
    return rows.tobytes().decode("ascii").split("\n")[:-1]


def random_texts(rng: np.random.Generator, lengths: np.ndarray) -> List[str]:
    words = rng.integers(0, VOCAB_WORDS, int(lengths.sum()), dtype=np.int64)
    return texts_from_words(words, lengths)


# -- the fixed corpus -----------------------------------------------------------


def passage_chunk(corpus_seed: int, chunk: int, n_total: int, law: dict) -> List[str]:
    """Texts of passages [chunk * TEXT_CHUNK, ...) of the corpus."""
    lo = chunk * TEXT_CHUNK
    n = min(TEXT_CHUNK, n_total - lo)
    rng = np.random.default_rng(subseed(corpus_seed, 1, chunk))
    return random_texts(rng, draw_lengths(rng, n, law))


def passages_at(corpus_seed: int, positions: Sequence[int], n_total: int,
                law: dict) -> dict:
    """{position: text} for any corpus positions (regenerates their chunks)."""
    out, by_chunk = {}, {}
    for p in positions:
        by_chunk.setdefault(int(p) // TEXT_CHUNK, []).append(int(p))
    for chunk, ps in by_chunk.items():
        texts = passage_chunk(corpus_seed, chunk, n_total, law)
        for p in ps:
            out[p] = texts[p - chunk * TEXT_CHUNK]
    return out


def passage_id(position: int) -> str:
    return f"p{position:09d}"


def vector_block(torch, corpus_seed: int, block: int, n_total: int, dim: int, device):
    """Raw f32 rows [block * VECTOR_BLOCK, ...) of the corpus, made on
    ``device`` from the block's own generator (not normalized)."""
    lo = block * VECTOR_BLOCK
    n = min(VECTOR_BLOCK, n_total - lo)
    gen = torch.Generator(device=device).manual_seed(subseed(corpus_seed, 2, block))
    return torch.randn((n, dim), generator=gen, device=device, dtype=torch.float32)


def n_blocks(n_total: int, size: int) -> int:
    return -(-n_total // size)
