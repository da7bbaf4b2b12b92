"""Readings of the LFM2-MoE reranker's new layers (``models/lfm2_moe.py``):
its expert GEMMs, routing and short convolutions, from the device trace
of a ``--trace 1`` run, and its routing counts from the program's spans.

Each returns None where the run gives it nothing to read: no trace, no
range of its layer in the window (a program without the model), or no
span carrying the counts.
"""

from __future__ import annotations

from typing import Optional

from bench_torch import program_spans, roofline, roofline_lfm2moe


def _pairs(run) -> list:
    lo, hi = run.trace.window_bounds()
    return [x for t, items in run.spans.records["pairs"] if lo <= t <= hi for x in items]


def _range_s(run, name: str) -> float:
    return run.trace.device_s_by_range().get(name, 0.0)


def moe_roofline_pct(run) -> Optional[float]:
    """The expert FFN's bound (the live tokens' assignments at the bf16
    peak, or each layer call's expert weights read once, the larger) over
    the device time of the kernels inside the ``moe_experts`` ranges, in %."""
    if run.trace is None:
        return None
    tokens = sum(_pairs(run))
    calls = sum(1 for r in run.trace.events["ranges"] if r[0] == "moe_experts")
    seconds = _range_s(run, "moe_experts")
    if not tokens or not calls or seconds <= 0:
        return None
    return roofline.share_pct(roofline_lfm2moe.moe_bound_s(run.system.rr_cfg, tokens, calls),
                              seconds)


def short_conv_roofline_pct(run) -> Optional[float]:
    """B, C and x read and y written once a live token a conv layer, in
    bf16 at the HBM rate, over the device time inside ``short_conv``, in %."""
    if run.trace is None:
        return None
    tokens = sum(_pairs(run))
    seconds = _range_s(run, "short_conv")
    if not tokens or seconds <= 0:
        return None
    return roofline.share_pct(roofline_lfm2moe.short_conv_bound_s(run.system.rr_cfg, tokens),
                              seconds)


def moe_route_ms_per_query(run) -> Optional[float]:
    """Device ms a reranked query inside the ``moe_route`` ranges."""
    if run.trace is None:
        return None
    lo, hi = run.trace.window_bounds()
    queries = sum(x for t, items in run.spans.records["rerank_queries"] if lo <= t <= hi
                  for x in items)
    seconds = _range_s(run, "moe_route")
    if not queries or seconds <= 0:
        return None
    return 1e3 * seconds / queries


def moe_load_pct(run) -> Optional[float]:
    """The routed assignments over (experts × the busiest expert's rows),
    summed over the ``rerank.forward`` spans in the window, in %: 100 where
    every expert gets the same rows."""
    assigned = busiest = 0
    for s in program_spans.program_spans(run):
        if s.name == "rerank.forward":
            assigned += s.attrs.get("moe_assignments", 0)
            busiest += s.attrs.get("moe_busiest", 0)
    if assigned <= 0 or busiest <= 0:
        return None
    return 100.0 * assigned / (run.system.rr_cfg["num_experts"] * busiest)
