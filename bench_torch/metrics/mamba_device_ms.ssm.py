"""Device ms a reranked query spends inside the Granite reranker's Mamba mixers, their projections included."""

from bench_torch import readers_granite4h


def read(run):
    return readers_granite4h.mamba_ms_per_query(run)
