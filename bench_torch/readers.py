"""What the per-layer metric files (``metrics/<name>.py``) share.

Each reader returns None where the run gives it nothing to read (no call
of its layer in the window, or no device trace), and never 0 for a share.
"""

from __future__ import annotations

from typing import Optional

from bench_torch import roofline


def device_ms_per_call(run, layer: str) -> Optional[float]:
    """Device ms of the kernels launched inside ``layer``'s ranges, per call."""
    if run.trace is None:
        return None
    calls = sum(1 for r in run.trace.events["ranges"] if r[0] == layer)
    seconds = run.trace.device_s_by_range().get(layer, 0.0)
    if calls == 0 or seconds <= 0:
        return None
    return 1e3 * seconds / calls


def host_ms_per_call(run, *layers: str) -> Optional[float]:
    calls = sum(run.spans.calls.get(x, 0) for x in layers[:1])
    seconds = sum(run.spans.host_s.get(x, 0.0) for x in layers)
    if calls == 0:
        return None
    return 1e3 * seconds / calls


def queries_per_batch(run) -> Optional[float]:
    b = run.counters.get("batcher_batches", 0)
    if not b:
        return None
    return run.counters["batcher_queries"] / b


def idle_pct(run) -> Optional[float]:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    busy = run.trace.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / run.trace.window_s)


def step_mfu_pct(run) -> Optional[float]:
    flops = run.counters.get("model_flops", 0.0)
    if flops <= 0:
        return None
    return roofline.share_pct(flops / roofline.BF16_FLOPS, run.window_s)


def search_roofline_pct(run) -> Optional[float]:
    if run.trace is None:
        return None
    lo, hi = run.trace.window_bounds()
    searches = [x for t, items in run.spans.records["search"] if lo <= t <= hi for x in items]
    seconds = run.trace.device_s_by_range().get("search", 0.0)
    if not searches or seconds <= 0:
        return None
    return roofline.share_pct(run.system.search_bound_s(searches), seconds)


def attention_roofline_pct(run) -> Optional[float]:
    if run.trace is None:
        return None
    lo, hi = run.trace.window_bounds()
    pairs = [x for t, items in run.spans.records["pairs"] if lo <= t <= hi for x in items]
    seconds = run.trace.device_s_by_range().get("attn", 0.0)
    if not pairs or seconds <= 0:
        return None
    return roofline.share_pct(run.system.attention_bound_s(pairs), seconds)


def rerank_ms_per_query(run) -> Optional[float]:
    if run.trace is None:
        return None
    lo, hi = run.trace.window_bounds()
    queries = sum(x for t, items in run.spans.records["rerank_queries"] if lo <= t <= hi
                  for x in items)
    seconds = run.trace.device_s_by_range().get("rerank", 0.0)
    if not queries or seconds <= 0:
        return None
    return 1e3 * seconds / queries
