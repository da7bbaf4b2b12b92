"""Device ms a reranked query inside the moe_route ranges (the router, top-k, sort and offsets)."""

from bench_torch import readers_moe


def read(run):
    return readers_moe.moe_route_ms_per_query(run)
