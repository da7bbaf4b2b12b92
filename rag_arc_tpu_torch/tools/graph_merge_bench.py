"""GraphRAG entity merge at scale (counterpart of the top-level
``tools/graph_merge_bench.py``).

The reference's merge pass is an O(N²) sklearn cosine_similarity matrix +
GDS Louvain + APOC migration (Base_Neo4j.py:508-712): at 100k entities the
similarity matrix alone is 40 GB. Here the SIMILAR edge list comes from
the flat index's batched top-k self-search (``graph/store.py::
_similar_pairs``; on the card, chunks past the score budget run
``csrc/subtile_max.cu`` in its f32 mode and ``csrc/subtile_select.cu``),
and the cluster merge is one host union-find + one edge-list rebuild.

Two corpora, built with the JAX tool's numpy generator and draws, so both
packages build the same entities and edges from one ``--seed``:

- default: N entities of which ``--dup-frac`` are near-duplicate pairs
  (cosine ≈ 0.97, above the 0.95 threshold). Reports embed + index time,
  merge wall time, recall against the planted pairs, and the O(N²) numpy
  pass on a subsample, extrapolated.
- ``--hard``: chained near-duplicate clusters of size 2-8 (adjacent
  cosine ≈ 0.963 at t = 0.28, four or more steps apart under 0.95, so they
  fold only through union-find transitivity), boundary negative pairs at
  cosine ≈ 0.936 (t = 0.375) that must not merge, and ~2 relations an
  entity whose endpoints must survive the migration. Asserts no dangling
  edges and no entity self-loops.

Usage::

    python -m rag_arc_tpu_torch.tools.graph_merge_bench [--hard] [--n 100000]
        [--dim 768] [--seed 0] [--device cuda]

On the CPU pass ``--device cpu`` and a small ``--n``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Tuple

import numpy as np

T_POS, T_NEG = 0.28, 0.375  # the hard corpus's chain and negative noise norms


class VecEmbeddings:
    """Deterministic content → vector lookup (planted geometry)."""

    def __init__(self, table: Dict[str, np.ndarray]):
        self.table = table
        self.dim = next(iter(table.values())).shape[0]

    def encode(self, texts):
        return np.stack([self.table[t] for t in texts])

    def embed_documents(self, texts):
        return self.encode(texts).tolist()

    def embed_query(self, text):
        return self.table[text].tolist()

    def describe(self):
        return {"kind": "planted", "dim": self.dim}


@dataclasses.dataclass
class HardCorpus:
    names: List[str]
    vecs: np.ndarray  # (n, dim) f32, unit rows
    clusters: List[List[str]]  # planted positive clusters
    neg_pairs: List[Tuple[str, str]]  # boundary negatives (must NOT merge)
    edges: List[Tuple[str, str]]  # ENTITY_RELATION endpoints, in add order


def hard_corpus(n: int, dim: int, seed: int = 0) -> HardCorpus:
    """The JAX tool's hard corpus, draw for draw. Orthogonal noise of total
    norm t gives adjacent cosine ≈ 1/sqrt(1+t²); chains random-walk, so
    cos(v0, v_k) ≈ 1/sqrt(1+k·t²). ~20% of the entities live in chains,
    ~4% in negative pairs, the rest are background; then the chain edges
    and random edges up to ~2 relations an entity."""
    rng = np.random.default_rng(seed)

    def walk(v0, steps, t):
        out = [v0]
        for _ in range(steps):
            nxt = out[-1] + (t / np.sqrt(dim)) * rng.standard_normal(dim).astype(np.float32)
            out.append(nxt / np.linalg.norm(nxt))
        return out

    vecs: list = []
    names: list = []
    clusters: list = []
    neg_pairs: list = []
    i = 0
    n_cluster_rows = int(n * 0.20)
    n_neg_rows = int(n * 0.04)
    while sum(len(c) for c in clusters) < n_cluster_rows:
        size = int(rng.integers(2, 9))
        v0 = rng.standard_normal(dim).astype(np.float32)
        v0 /= np.linalg.norm(v0)
        members = []
        for v in walk(v0, size - 1, T_POS):
            nm = f"c{len(clusters)}_m{len(members)}_{i}"
            names.append(nm)
            vecs.append(v)
            members.append(nm)
            i += 1
        clusters.append(members)
    for j in range(n_neg_rows // 2):
        v0 = rng.standard_normal(dim).astype(np.float32)
        v0 /= np.linalg.norm(v0)
        _, v1 = walk(v0, 1, T_NEG)
        a, b = f"neg{j}_a_{i}", f"neg{j}_b_{i + 1}"
        names += [a, b]
        vecs += [v0, v1]
        neg_pairs.append((a, b))
        i += 2
    while len(names) < n:
        v = rng.standard_normal(dim).astype(np.float32)
        names.append(f"bg_{i}")
        vecs.append(v / np.linalg.norm(v))
        i += 1
    edges = [(a, b) for members in clusters for a, b in zip(members, members[1:])]
    rnd = rng.integers(0, len(names), size=(2 * n - 2 * len(edges), 2))
    edges += [(names[a], names[b]) for a, b in rnd.tolist() if a != b]
    return HardCorpus(names, np.stack(vecs), clusters, neg_pairs, edges)


def default_corpus(n: int, dim: int, dup_frac: float = 0.10, seed: int = 0):
    """The JAX tool's default corpus: (names, vecs, n_dup). The first
    ``n_dup`` base rows get a near-duplicate each: noise of TOTAL norm 0.25
    puts the pair cosine ≈ 0.97."""
    rng = np.random.default_rng(seed)
    n_dup = int(n * dup_frac) // 2
    base = rng.standard_normal((n - n_dup, dim), dtype=np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    dup = base[:n_dup] + (0.25 / np.sqrt(dim)) * rng.standard_normal(
        (n_dup, dim), dtype=np.float32
    )
    dup /= np.linalg.norm(dup, axis=1, keepdims=True)
    vecs = np.concatenate([base, dup])
    names = [f"entity_{i}" for i in range(len(base))] + [
        f"entity_dup_{i}" for i in range(n_dup)
    ]
    return names, vecs, n_dup


def planted_store(names, vecs, *, device, edges=()):
    """An ``ArrayGraphStore`` holding one entity a name (content = name,
    vector = its planted row) and the given ENTITY_RELATION edges; returns
    (store, edges added, upsert + edge seconds). Embeddings are not
    generated yet."""
    from rag_arc_tpu_torch.graph.schema import GraphEdge, GraphNode
    from rag_arc_tpu_torch.graph.store import ArrayGraphStore

    store = ArrayGraphStore(VecEmbeddings(dict(zip(names, vecs))), device=device)
    store.embed_batch = 8192
    t0 = time.perf_counter()
    for name in names:
        store.upsert_node(GraphNode(key=name, kind="entity", content=name))
    added = 0
    for a, b in edges:
        if store.add_edge(GraphEdge(src=a, dst=b, edge_type="ENTITY_RELATION")):
            added += 1
    return store, added, time.perf_counter() - t0


def hard_report(store, corpus: HardCorpus) -> dict:
    """Planted-cluster collapse (every chain must fold to ONE survivor),
    boundary negatives (both must survive) and migration correctness (no
    dangling endpoints, no entity self-loops) after a merge."""
    live = store.nodes["entity"]
    fully = partial = 0
    for members in corpus.clusters:
        remaining = sum(1 for m in members if m in live)
        if remaining == 1:
            fully += 1
        elif remaining < len(members):
            partial += 1
    neg_ok = sum(1 for a, b in corpus.neg_pairs if a in live and b in live)
    dangling = sum(1 for e in store.edges if e.src not in live or e.dst not in live)
    self_loops = sum(
        1 for e in store.edges if e.src == e.dst and e.edge_type == "ENTITY_RELATION"
    )
    return {
        "clusters": len(corpus.clusters),
        "clusters_fully_collapsed": fully,
        "clusters_partial": partial,
        "cluster_collapse_rate": fully / len(corpus.clusters),
        "boundary_negatives_preserved": neg_ok,
        "boundary_negatives": len(corpus.neg_pairs),
        "dangling_edges": dangling,
        "entity_self_loops": self_loops,
        "edges_after": len(store.edges),
    }


def run_hard(args) -> dict:
    t0 = time.perf_counter()
    corpus = hard_corpus(args.n, args.dim, args.seed)
    print(f"corpus built {time.perf_counter() - t0:.1f} s: {len(corpus.clusters)} "
          f"clusters (sizes 2-8), {len(corpus.neg_pairs)} boundary negatives", flush=True)
    store, edge_count, upsert_s = planted_store(
        corpus.names, corpus.vecs, device=args.device, edges=corpus.edges)
    t0 = time.perf_counter()
    embedded = store.generate_embeddings()
    embed_s = time.perf_counter() - t0
    print(f"upsert+edges {upsert_s:.1f} s embed+index {embed_s:.1f} s ({embedded} nodes, "
          f"{edge_count} edges)", flush=True)
    t0 = time.perf_counter()
    merged = store.merge_duplicate_entities()
    merge_s = time.perf_counter() - t0
    out = {"mode": "hard", "n_entities": args.n, "device": args.device,
           "merge_wall_s": merge_s, "merged_entities": merged,
           **hard_report(store, corpus), "entities_per_s_merge": args.n / merge_s}
    print(json.dumps(out), flush=True)
    assert out["dangling_edges"] == 0, "edge migration left dangling endpoints"
    assert out["entity_self_loops"] == 0, "merge left entity self-loops"
    return out


def run_default(args) -> dict:
    names, vecs, n_dup = default_corpus(args.n, args.dim, args.dup_frac, args.seed)
    store, _, upsert_s = planted_store(names, vecs, device=args.device)
    t0 = time.perf_counter()
    embedded = store.generate_embeddings()
    embed_s = time.perf_counter() - t0
    print(f"upsert {upsert_s:.1f} s embed+index {embed_s:.1f} s ({embedded} nodes)",
          flush=True)
    t0 = time.perf_counter()
    merged = store.merge_duplicate_entities()
    merge_s = time.perf_counter() - t0
    # the reference-shaped O(N²) pass on a subsample (sklearn semantics:
    # full cosine matrix + threshold scan), extrapolated quadratically
    m = min(args.oracle_n, args.n)
    sub = vecs[:m]
    t0 = time.perf_counter()
    sims = sub @ sub.T
    _ = np.argwhere(np.triu(sims, 1) >= 0.95)
    on2_s = time.perf_counter() - t0
    out = {
        "n_entities": args.n, "device": args.device, "planted_dup_pairs": n_dup,
        "embed_index_s": embed_s, "merge_wall_s": merge_s, "merged_entities": merged,
        "planted_recall": merged / n_dup if n_dup else 1.0,
        "entities_per_s_merge": args.n / merge_s,
        "ref_on2_numpy_s_at_subsample": on2_s, "ref_on2_subsample": m,
        "ref_on2_extrapolated_s": on2_s * (args.n / m) ** 2,
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--dup-frac", type=float, default=0.10)
    ap.add_argument("--oracle-n", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hard", action="store_true",
                    help="chained near-duplicate clusters, boundary negatives and "
                         "~2 relations an entity (see the module docstring)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        import torch

        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    return run_hard(args) if args.hard else run_default(args)


if __name__ == "__main__":
    main()
