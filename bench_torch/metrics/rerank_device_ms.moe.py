"""Device ms of the LFM2-MoE reranker's kernels per query reranked."""

from bench_torch import readers


def read(run):
    return readers.rerank_ms_per_query(run)
