"""Routed assignments over (experts x the busiest expert's rows), from the rerank.forward spans' counts, in %: 100 where the experts share the rows evenly."""

from bench_torch import readers_moe


def read(run):
    return readers_moe.moe_load_pct(run)
