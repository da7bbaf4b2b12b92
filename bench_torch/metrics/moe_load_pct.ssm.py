"""Held assignments over (held experts x the busiest held expert's rows), from the rerank.forward spans' counts, in %: 100 where the held experts share their rows evenly."""

from bench_torch import readers_granite4h


def read(run):
    return readers_granite4h.moe_load_pct(run)
