"""Routed assignments that landed on this card's experts over all routed assignments (rerank.forward spans' moe_held over moe_assignments), in %."""

from bench_torch import readers_granite4h


def read(run):
    return readers_granite4h.moe_held_pct(run)
