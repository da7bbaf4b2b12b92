"""The program's own spans in a run's window, joined with the card's trace.

The port records request-scoped spans (``rag_arc_tpu_torch/utils/
tracing.py``) while a torch profiler records, stamped with
``time.time_ns()``, the clock the profiler stamps the card's operations
with. A ``--trace 1`` run therefore holds them for its window, and these
readings join them with ``run.trace.busy_intervals()`` by time. A
program without such spans (an earlier commit's) yields none, and every
reading is then None.
"""

from __future__ import annotations

import heapq
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np


def window_ns(run) -> Tuple[int, int]:
    lo, hi = run.window
    return int(lo * 1e9), int(hi * 1e9)


def program_spans(run, overlapping: bool = False, everything: bool = False) -> list:
    """The program's spans that ended inside the run's window; with
    ``overlapping``, those that overlap it at all; with ``everything``,
    every span the program kept."""
    try:
        from rag_arc_tpu_torch.utils import tracing
    except ImportError:
        return []
    read = getattr(tracing, "spans", None)
    if read is None:
        return []
    if everything:
        return read(None, None)
    lo, hi = window_ns(run)
    if overlapping:
        return [s for s in read(lo, None) if s.start_ns <= hi]
    return read(lo, hi)


def _roots(spans: list, root: str) -> list:
    return [s for s in spans if s.name == root]


def mean_request_ms(run, names: Tuple[str, ...], *, union: bool = False) -> Optional[float]:
    """Mean over the requests answered in the window (``http.request``
    spans that ended in it) of their ``names`` spans, wherever those
    fell: summed, or with ``union`` the time from the first start to the
    last end."""
    requests = {s.request for s in _roots(program_spans(run), "http.request")}
    if not requests:
        return None
    parts: Dict[object, List[Tuple[int, int]]] = defaultdict(list)
    for s in program_spans(run, everything=True):
        if s.name in names and s.request in requests:
            parts[s.request].append((s.start_ns, s.end_ns))
    if not parts:
        return None
    if union:
        per = [max(e for _, e in p) - min(s for s, _ in p) for p in parts.values()]
    else:
        per = [sum(e - s for s, e in p) for p in parts.values()]
    return float(np.mean(per)) / 1e6


def fill_pct(run, name: str) -> Optional[float]:
    """Real tokens over token slots of the ``name`` spans in the window, in %."""
    tokens = slots = 0
    for s in program_spans(run):
        if s.name == name:
            tokens += s.attrs.get("tokens", 0)
            slots += s.attrs.get("slots", 0)
    if slots <= 0 or tokens <= 0:
        return None
    return 100.0 * tokens / slots


def host_ms_per_call(run, calls: str, *names: str) -> Optional[float]:
    """Host ms of the ``names`` spans in the window per ``calls`` span."""
    spans = program_spans(run)
    n = sum(1 for s in spans if s.name == calls)
    if n == 0:
        return None
    return sum(s.end_ns - s.start_ns for s in spans if s.name in names) / 1e6 / n


def _busy(run, lo: int, hi: int) -> Tuple[np.ndarray, np.ndarray]:
    """The card's busy intervals clipped to [lo, hi], as (starts, ends)."""
    iv = np.asarray(run.trace.busy_intervals(), dtype=np.int64).reshape(-1, 2)
    s, e = np.clip(iv[:, 0], lo, hi), np.clip(iv[:, 1], lo, hi)
    keep = e > s
    return s[keep], e[keep]


def _busy_before(bs: np.ndarray, be: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Busy ns before each t (intervals sorted and disjoint)."""
    if len(bs) == 0:
        return np.zeros_like(t)
    done = np.concatenate([[0], np.cumsum(be - bs)])
    i = np.searchsorted(be, t, side="right")  # intervals ended by t
    partial = np.where(i < len(bs), np.clip(t - bs[np.minimum(i, len(bs) - 1)], 0, None), 0)
    return done[i] + partial


def idle_split(run, root: str) -> Optional[Tuple[Dict[str, float], float]]:
    """The window's idle card seconds, split by the innermost program span
    open during them (the open span that started last) while a ``root``
    span is open, and under ``no <root> open`` otherwise; and the window's
    seconds. None without a device trace or a ``root`` span."""
    if run.trace is None:
        return None
    spans = program_spans(run, overlapping=True)
    if not _roots(spans, root):
        return None
    lo, hi = window_ns(run)
    events = []  # (time, 0 = end before 1 = start, index)
    for i, s in enumerate(spans):
        a, b = max(s.start_ns, lo), min(s.end_ns, hi)
        if b > a:
            events.append((a, 1, i))
            events.append((b, 0, i))
    events.sort()
    bs, be = _busy(run, lo, hi)
    outside = f"no {root} open"
    cuts, labels = [lo], []
    heap: list = []  # (-start, duration, index) of open spans
    open_ = set()
    roots_open = 0
    label = outside
    for t, kind, i in events:
        if t > cuts[-1]:
            labels.append(label)
            cuts.append(t)
        s = spans[i]
        if kind:
            open_.add(i)
            heapq.heappush(heap, (-s.start_ns, s.end_ns - s.start_ns, i))
            roots_open += s.name == root
        else:
            open_.discard(i)
            roots_open -= s.name == root
        while heap and heap[0][2] not in open_:
            heapq.heappop(heap)
        label = spans[heap[0][2]].name if roots_open and heap else outside
    if hi > cuts[-1]:
        labels.append(label)
        cuts.append(hi)
    t = np.asarray(cuts, dtype=np.int64)
    busy = np.diff(_busy_before(bs, be, t))
    idle = (np.diff(t) - busy) / 1e9
    split: Dict[str, float] = defaultdict(float)
    for name, sec in zip(labels, idle.tolist()):
        split[name] += sec
    return dict(split), (hi - lo) / 1e9


def report_split(split: Dict[str, float], window_s: float, cell: str) -> None:
    """One line on standard error: the idle split, largest first."""
    total = sum(split.values())
    parts = ", ".join(f"{k} {v!r}" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
    print(f"idle card seconds by innermost program span ({cell}; {total!r} s idle of "
          f"{window_s!r} s): {parts}", file=sys.stderr, flush=True)


def inflight_idle_pct(run) -> Optional[float]:
    """Share of the window in which the card is idle while at least one
    ``http.request`` is open, in %; writes the idle split."""
    got = idle_split(run, "http.request")
    if got is None:
        return None
    split, window_s = got
    report_split(split, window_s, "served")
    inflight = sum(v for k, v in split.items() if k != "no http.request open")
    if inflight <= 0:
        return None
    return 100.0 * inflight / window_s
