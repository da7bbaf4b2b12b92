"""Device ms a reranked query inside the Granite reranker's moe_route ranges."""

from bench_torch import readers_moe


def read(run):
    return readers_moe.moe_route_ms_per_query(run)
