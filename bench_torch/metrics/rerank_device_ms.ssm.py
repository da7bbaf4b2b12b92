"""Device ms of the Granite 4.0-H reranker's kernels per query reranked."""

from bench_torch import readers


def read(run):
    return readers.rerank_ms_per_query(run)
