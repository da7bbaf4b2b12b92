"""IVF recall against a FAISS-defaults oracle (the port's copy of the JAX
package's ``tools/ivf_oracle.py``).

The corpus is the JAX tool's clustered one, drawn in the same order from
``numpy.random.default_rng(0)``: 256 gaussian centres (deliberately not
nlist), rows = centre + noise·U(-½, ½), unit-normalized, and queries that
are perturbed corpus rows. The oracle is an IVF built with FAISS's
training recipe (k-means on at most 256 points a list, 25 Lloyd
iterations, ``kmeans_faiss_defaults``), nearest-centroid assignment
(``assign``) and an exact f32 scan of the probed lists; the exact top-k
over the whole corpus is the ground truth. The k-means and assignment are
numpy, copied; the exact top-k and the probed scan run in torch on the
given device (the probed scan as the exact scores of the rows whose list
is probed, which is the same top-k as scanning those lists).

    python -m rag_arc_tpu_torch.tools.ivf_oracle --n 1000000
        [--nlist 100] [--queries 1024] [--dtype bf16|f32|int8] [--spills 1,2]

prints the oracle's recall@10 and scanned fraction at each nprobe, then
the port's ``DeviceIVFIndex`` at the same operating points.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Tuple

import numpy as np
import torch

from rag_arc_tpu_torch.ops.bm25 import full_f32_matmul

N_CENTERS = 256
CHUNK = 1 << 18


def clustered_corpus(
    n: int, d: int, queries: int, noise: float = 0.3, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.random.Generator]:
    """(corpus (n, d) f32 unit rows, queries (queries, d) f32 unit rows,
    the generator in the state the oracle's k-means continues from)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((N_CENTERS, d)).astype(np.float32)
    asg = rng.integers(0, N_CENTERS, n)
    corpus = centers[asg] + noise * (rng.random((n, d), dtype=np.float32) - 0.5)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    del asg
    q = corpus[rng.integers(0, n, queries)] + 0.1 * (
        rng.standard_normal((queries, d)).astype(np.float32)
    )
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return corpus, q, rng


def kmeans_faiss_defaults(
    x: np.ndarray, nlist: int, rng: np.random.Generator,
    niter: int = 25, max_per_list: int = 256,
) -> np.ndarray:
    """FAISS Clustering defaults: train on ≤256*nlist subsampled points,
    25 Lloyd iterations, empty clusters re-seeded from a random point."""
    cap = max_per_list * nlist
    train = x[rng.choice(len(x), size=min(cap, len(x)), replace=False)]
    train = np.ascontiguousarray(train, dtype=np.float32)
    cent = train[rng.choice(len(train), size=nlist, replace=False)].copy()
    for _ in range(niter):
        # nearest centroid by L2 == max (c·x - |c|²/2)
        scores = train @ cent.T - 0.5 * (cent * cent).sum(1)[None, :]
        a = scores.argmax(1)
        for j in range(nlist):
            m = a == j
            if m.any():
                cent[j] = train[m].mean(0)
            else:
                cent[j] = train[rng.integers(len(train))]
    return cent


def assign(x: np.ndarray, cent: np.ndarray, chunk: int = 65536) -> np.ndarray:
    out = np.empty(len(x), np.int32)
    c2 = 0.5 * (cent * cent).sum(1)[None, :]
    for s in range(0, len(x), chunk):
        out[s : s + chunk] = (x[s : s + chunk] @ cent.T - c2).argmax(1)
    return out


def masked_topk(
    corpus: torch.Tensor, q: torch.Tensor, k: int, row_ok=None
) -> np.ndarray:
    """(B, k) ids of the exact f32 top-k of ``q @ corpus.T`` over the rows
    where ``row_ok(start, stop)`` (a (B, rows) bool) holds, in row chunks."""
    b = q.shape[0]
    best_s = torch.full((b, k), float("-inf"), device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
    with full_f32_matmul():
        for s in range(0, corpus.shape[0], CHUNK):
            sc = q @ corpus[s : s + CHUNK].T
            if row_ok is not None:
                sc = torch.where(row_ok(s, s + sc.shape[1]), sc, float("-inf"))
            top_s, top_i = torch.topk(sc, min(k, sc.shape[1]), dim=1)
            cat_s = torch.cat([best_s, top_s], dim=1)
            cat_i = torch.cat([best_i, top_i + s], dim=1)
            best_s, sel = torch.topk(cat_s, k, dim=1)
            best_i = torch.gather(cat_i, 1, sel)
    return torch.where(torch.isneginf(best_s), -1, best_i).cpu().numpy()


class Oracle:
    """The FAISS-defaults IVF over a corpus on ``device``."""

    def __init__(self, corpus: np.ndarray, corpus_dev: torch.Tensor, nlist: int,
                 rng: np.random.Generator):
        self.corpus, self.nlist = corpus_dev, nlist
        self.cent = kmeans_faiss_defaults(corpus, nlist, rng)
        a = assign(corpus, self.cent)
        self.sizes = np.bincount(a, minlength=nlist)
        self.assign = torch.from_numpy(a.astype(np.int64)).to(corpus_dev.device)

    def search(self, q: np.ndarray, k: int, nprobe: int) -> Tuple[np.ndarray, float]:
        """(ids (B, k), scanned fraction) of the exact scan of each
        query's ``nprobe`` nearest lists (ip ranking of the centroids, as
        FAISS IVFFlat with the IP metric)."""
        probe = np.argsort(-(q @ self.cent.T), axis=1)[:, :nprobe]
        probed = np.zeros((len(q), self.nlist), dtype=bool)
        np.put_along_axis(probed, probe, True, axis=1)
        scan_frac = float(self.sizes[probe].sum() / (len(q) * self.corpus.shape[0]))
        probed_dev = torch.from_numpy(probed).to(self.corpus.device)
        ids = masked_topk(self.corpus, torch.from_numpy(q).to(self.corpus.device), k,
                          lambda s, e: probed_dev[:, self.assign[s:e]])
        return ids, scan_frac


def recall(ids: np.ndarray, exact: np.ndarray) -> float:
    k = exact.shape[1]
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                          for a, b in zip(ids, exact)]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--nlist", type=int, default=100)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--nprobes", type=str, default="1,2,4,8,16,32")
    ap.add_argument("--spills", type=str, default="1")
    ap.add_argument("--noise", type=float, default=0.3)
    ap.add_argument("--dtype", choices=("bf16", "f32", "int8"), default="bf16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from rag_arc_tpu_torch.index.ivf import DeviceIVFIndex

    dev = torch.device(args.device)
    nprobes = [int(s) for s in args.nprobes.split(",")]
    corpus, q, rng = clustered_corpus(args.n, args.d, args.queries, args.noise)
    corpus_dev = torch.from_numpy(corpus).to(dev)
    exact = masked_topk(corpus_dev, torch.from_numpy(q).to(dev), args.k)
    oracle = Oracle(corpus, corpus_dev, args.nlist, rng)
    for nprobe in nprobes:
        ids, frac = oracle.search(q, args.k, nprobe)
        print(json.dumps({"index": "oracle_faiss_ivf", "nlist": args.nlist,
                          "nprobe": nprobe, "scan_frac": frac,
                          "recall": recall(ids, exact)}), flush=True)
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}[args.dtype]
    for spill in [int(s) for s in args.spills.split(",")]:
        t0 = time.time()
        ivf = DeviceIVFIndex.from_vectors(corpus, nlist=args.nlist, metric="cosine",
                                          dtype=dtype, spill=spill, device=dev)
        build_s = time.time() - t0
        for nprobe in nprobes:
            _, got = ivf.search(q, args.k, nprobe=nprobe)
            print(json.dumps({"index": "rag_arc_ivf", "dtype": args.dtype,
                              "nlist": args.nlist, "spill": spill, "nprobe": nprobe,
                              "scan_frac_upper": nprobe * ivf.lmax / args.n,
                              "recall": recall(got, exact), "build_s": build_s,
                              "build_split_s": ivf.build_seconds}), flush=True)
        del ivf


if __name__ == "__main__":
    main()
