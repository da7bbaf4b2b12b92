"""The one general generator: a traffic file's parameters and a seed in,
the requests of a run out.

A traffic file (``traffic/<name>.json``) has a ``loop``:

- ``closed``: ``clients`` callers, each sending ``/batch`` requests of
  ``queries_per_request`` queries one after another; each caller cycles
  through ``bodies_per_client`` distinct bodies.
- ``open``: ``/batch`` requests of ``queries_per_request`` queries due on a
  schedule that is the same for every seed: ``arrivals`` "poisson" at
  ``rate_per_s`` (rate × seconds requests, their exponential gaps taken at
  stratified quantiles in a fixed shuffled order); ``clients`` connections
  are opened up front.
- ``ingest``: one job adding ``batch_docs`` documents a call.

Query and passage word counts follow ``query_words`` / ``passage_words``
({mean, sigma, cap}: a capped lognormal), at stratified quantiles in a
seeded order. ``k`` and ``response`` go into every request body.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from bench_torch import data

ARRIVALS_SEED = 0xA771_5EED  # the open loop's schedule: fixed, not the run's seed


@dataclass
class Stream:
    """What one served run sends."""

    bodies: List[bytes]
    queries: List[List[str]]          # per body
    words: List[List[int]]            # per body: each query's word count
    loop: str
    clients: int
    order: list                       # closed: per client body ids; open: body per request
    due: Optional[List[float]] = None  # open: seconds after the window opens
    keep: List[int] = field(default_factory=list)


def _bodies(rng, n: int, qpr: int, law: dict, k: int, response: str):
    lengths = data.stratified_lengths(rng, n * qpr, law)
    texts = data.random_texts(rng, lengths)
    bodies, queries, words = [], [], []
    for i in range(n):
        q = texts[i * qpr:(i + 1) * qpr]
        queries.append(q)
        words.append([int(x) for x in lengths[i * qpr:(i + 1) * qpr]])
        bodies.append(json.dumps({"queries": q, "k": k, "response": response}).encode())
    return bodies, queries, words


def _schedule(rng, spec: dict, seconds: float) -> np.ndarray:
    """Poisson arrivals: exponential gaps at stratified quantiles in a
    fixed order, rescaled to fill the window, the first at its start."""
    if spec.get("arrivals", "poisson") != "poisson":
        raise ValueError(f"unknown arrivals {spec['arrivals']!r}")
    n = max(1, int(round(float(spec["rate_per_s"]) * seconds)))
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n)
    gaps = gaps[rng.permutation(n)]
    times = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    return times * (seconds / times[-1] * (n - 1) / n) if n > 1 else times


def served_stream(spec: dict, seed: int, seconds: float, n_check: int) -> Stream:
    rng = np.random.default_rng(data.subseed(seed, 3))
    qpr, law = int(spec["queries_per_request"]), spec["query_words"]
    k, response = int(spec["k"]), spec["response"]
    if spec["loop"] == "closed":
        clients, per = int(spec["clients"]), int(spec["bodies_per_client"])
        bodies, queries, words = _bodies(rng, clients * per, qpr, law, k, response)
        order = [list(range(c * per, (c + 1) * per)) for c in range(clients)]
        # the body with the longest query goes first on its client
        longest = int(np.argmax([max(w) for w in words]))
        lc = longest // per
        mine = order[lc]
        mine[0], mine[longest - lc * per] = mine[longest - lc * per], mine[0]
        # kept: the longest query's request, then the clients in a seeded
        # order, each's next request in turn (request id c * 1e6 + i)
        perm = [int(c) for c in rng.permutation(clients)]
        keep = [lc * 1_000_000]
        for j in range(n_check - 1):
            c = perm[j % clients]
            keep.append(c * 1_000_000 + 1 + j // clients)
        return Stream(bodies, queries, words, "closed", clients, order, keep=keep[:n_check])
    # the arrivals are the cell's, the same for every seed (a seed that moved
    # them would move the tail with them); the queries are the seed's
    due = _schedule(np.random.default_rng(data.subseed(ARRIVALS_SEED)), spec, seconds)
    n = len(due)
    bodies, queries, words = _bodies(rng, n, qpr, law, k, response)
    keep = sorted(int(i) for i in rng.choice(n, size=min(n_check, n), replace=False))
    # the request with the longest query is always among those checked
    longest = int(np.argmax([max(w) for w in words]))
    if longest not in keep:
        keep[0] = longest
    return Stream(bodies, queries, words, "open", int(spec["clients"]),
                  list(range(n)), due=[float(t) for t in due], keep=sorted(keep))


def ingest_batches(spec: dict, seed: int, n_batches: int):
    """``n_batches`` lists of (id, text): the ingest job's documents."""
    rng = np.random.default_rng(data.subseed(seed, 4))
    size = int(spec["batch_docs"])
    lengths = data.stratified_lengths(rng, n_batches * size, spec["passage_words"])
    texts = data.random_texts(rng, lengths)
    return [[(f"i{b * size + j:09d}", texts[b * size + j]) for j in range(size)]
            for b in range(n_batches)], lengths
