"""Readings of the Granite 4.0-H reranker's new layers
(``models/granite_hybrid.py``): its Mamba mixers, scan, convolution and
gated norm, and its held experts, from the device trace of a ``--trace 1``
run and the program's spans.

Each returns None where the run gives it nothing to read: no trace, no
range of its layer in the window (a program without the model), or no
span carrying the counts.
"""

from __future__ import annotations

from typing import Optional

from bench_torch import program_spans, roofline, roofline_granite4h


def _tokens(run) -> int:
    lo, hi = run.trace.window_bounds()
    return sum(x for t, items in run.spans.records["pairs"] if lo <= t <= hi for x in items)


def _range_s(run, name: str) -> float:
    return run.trace.device_s_by_range().get(name, 0.0)


def _share(run, name: str, bound) -> Optional[float]:
    """The bound of the window's live tokens over the device time inside
    the ``name`` ranges, in %."""
    if run.trace is None:
        return None
    tokens = _tokens(run)
    seconds = _range_s(run, name)
    if not tokens or seconds <= 0:
        return None
    return roofline.share_pct(bound(run.system.rr_cfg, tokens), seconds)


def ssd_roofline_pct(run) -> Optional[float]:
    return _share(run, "ssd_scan", roofline_granite4h.ssd_bound_s)


def mamba_conv_roofline_pct(run) -> Optional[float]:
    return _share(run, "mamba_conv", roofline_granite4h.mamba_conv_bound_s)


def gated_norm_roofline_pct(run) -> Optional[float]:
    return _share(run, "gated_rms_norm", roofline_granite4h.gated_norm_bound_s)


def mamba_ms_per_query(run) -> Optional[float]:
    """Device ms a reranked query inside the Mamba mixers' ranges."""
    if run.trace is None:
        return None
    lo, hi = run.trace.window_bounds()
    queries = sum(x for t, items in run.spans.records["rerank_queries"] if lo <= t <= hi
                  for x in items)
    seconds = _range_s(run, "mamba")
    if not queries or seconds <= 0:
        return None
    return 1e3 * seconds / queries


def _forward_counts(run) -> tuple:
    assigned = held = 0
    for s in program_spans.program_spans(run):
        if s.name == "rerank.forward":
            assigned += s.attrs.get("moe_assignments", 0)
            held += s.attrs.get("moe_held", 0)
    return assigned, held


def moe_roofline_pct(run) -> Optional[float]:
    """The held experts' FFN bound (the held assignments the spans count,
    at the bf16 peak, or each layer call's held expert weights read once,
    the larger) over the device time inside the ``moe_experts`` ranges, in %."""
    if run.trace is None:
        return None
    _, held = _forward_counts(run)
    calls = sum(1 for r in run.trace.events["ranges"] if r[0] == "moe_experts")
    seconds = _range_s(run, "moe_experts")
    if not held or not calls or seconds <= 0:
        return None
    return roofline.share_pct(roofline_granite4h.moe_bound_s(run.system.rr_cfg, held, calls),
                              seconds)


def moe_held_pct(run) -> Optional[float]:
    """The routed assignments that landed on this card's experts over all
    routed assignments, summed over the ``rerank.forward`` spans, in %."""
    assigned, held = _forward_counts(run)
    if assigned <= 0 or held <= 0:
        return None
    return 100.0 * held / assigned


def moe_load_pct(run) -> Optional[float]:
    """The held assignments over (held experts × the busiest held expert's
    rows), summed over the ``rerank.forward`` spans in the window, in %: 100
    where the held experts share their rows evenly."""
    held = busiest = 0
    for s in program_spans.program_spans(run):
        if s.name == "rerank.forward":
            held += s.attrs.get("moe_held", 0)
            busiest += s.attrs.get("moe_busiest", 0)
    if held <= 0 or busiest <= 0:
        return None
    lo, hi = run.system.rr_cfg["held_experts"]
    return 100.0 * held / ((hi - lo) * busiest)
