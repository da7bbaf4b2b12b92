"""Spans, counters and the device trace of a ``--trace 1`` run.

The harness places its spans from outside the program: it wraps bound
methods of the built objects (``store._resolve``, ``index.search_device``,
...) with ``torch.profiler.record_function`` ranges and host timers. No
program file is edited, and a ``--trace 0`` run installs none of them.

The profiler records user ranges (in every thread) and the card's
kernels, copies and sets; a kernel belongs to the range that launched
it (Kineto links it to the range's correlation id). From that:

- ``device_ms(name)``: kernel time launched inside ranges ``name``;
- ``busy_s``: the union of the card's operation intervals;
- ``breakdown``: the operations that took most time, and the idle gaps
  by the host range that was open during them.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

RANGE_PREFIX = "bench."


class Spans:
    """Host spans and counters the harness keeps, traced run or not."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.host_s: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.records: Dict[str, list] = defaultdict(list)
        self.local = threading.local()

    def add(self, name: str, seconds: float) -> None:
        with self.lock:
            self.host_s[name] += seconds
            self.calls[name] += 1

    def record(self, name: str, item) -> None:
        with self.lock:
            self.records[name].append(item)


def wrap(obj, attr: str, name: str, spans: Spans, torch, *, host: bool = False,
         ranged: bool = True, before: Optional[Callable] = None) -> None:
    """Replace ``obj.attr`` (a bound method, or a module's function) by one
    that opens the range ``bench.<name>`` (unless not ``ranged``); ``host``
    also sums its host time; ``before(args, kwargs)`` records what it needs."""
    inner = getattr(obj, attr)
    label = RANGE_PREFIX + name

    def wrapped(*args, **kwargs):
        if before is not None:
            before(args, kwargs)
        t0 = time.perf_counter()
        if ranged:
            with torch.profiler.record_function(label):
                out = inner(*args, **kwargs)
        else:
            out = inner(*args, **kwargs)
        if host:
            spans.add(name, time.perf_counter() - t0)
        else:
            with spans.lock:
                spans.calls[name] += 1
        return out

    setattr(obj, attr, wrapped)


def _is_annotation(event) -> bool:
    probe = getattr(event, "is_user_annotation", None)
    return bool(probe()) if probe is not None else False


class DeviceTrace:
    """The profiler over the measured window: user ranges in all threads,
    and the card's operations."""

    def __init__(self, torch) -> None:
        self.torch = torch
        self.events = None
        self.window_s = 0.0

    def prepare(self) -> None:
        """The profiler's own set-up (CUPTI), before the window opens."""
        from torch._C._autograd import _prepare_profiler
        from torch._C._profiler import (ProfilerActivity, ProfilerConfig, ProfilerState,
                                        _ExperimentalConfig)

        exp = _ExperimentalConfig(profile_all_threads=True)
        self._cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False, exp)
        self._acts = {ProfilerActivity.CPU}
        if self.torch.cuda.is_available():
            self._acts.add(ProfilerActivity.CUDA)
        _prepare_profiler(self._cfg, self._acts)

    def start(self) -> None:
        from torch._C._autograd import _enable_profiler
        from torch._C._profiler import RecordScope

        _enable_profiler(self._cfg, self._acts, {RecordScope.USER_SCOPE})
        self._t0 = time.time()

    def stop(self) -> None:
        from torch._C._autograd import _disable_profiler

        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self._t1 = time.time()
        self.window_s = self._t1 - self._t0
        result = _disable_profiler()
        self.events = self._collect(result)

    def _collect(self, result):
        from torch.autograd import DeviceType

        ranges, ops, projections = [], [], []
        for e in result.events():
            if e.device_type() == DeviceType.CPU:
                name = e.name()
                if name.startswith(RANGE_PREFIX):
                    ranges.append((name[len(RANGE_PREFIX):], e.start_ns(),
                                   e.start_ns() + e.duration_ns(), e.correlation_id(),
                                   e.start_thread_id()))
            else:
                name = e.name()
                start, end = e.start_ns(), e.start_ns() + e.duration_ns()
                # a range's projection on the card: from the first to the last
                # operation it launched; no operation itself
                if name.startswith(RANGE_PREFIX) or _is_annotation(e):
                    if name.startswith(RANGE_PREFIX):
                        projections.append((name[len(RANGE_PREFIX):], start, end))
                    continue
                ops.append((name, start, end, 0))
        return {"ranges": ranges, "ops": ops, "projections": projections}

    # -- readings ------------------------------------------------------------------

    def window_bounds(self):
        """(start, stop) of the traced window, time.time() seconds."""
        return self._t0, self._t1

    def device_s_by_range(self) -> Dict[str, float]:
        """Device seconds of the operations launched inside each range name,
        nested ranges included.

        Kineto projects each range onto the card, from the first to the
        last operation the range launched. An operation belongs to the
        shortest projection that holds it (ranges of other threads may
        overlap it, a range's own nested ones are shorter), and counts for
        that range's name and the names of the ranges enclosing it on the
        host (an attention call's kernels count for the reranker and the
        batch too)."""
        if getattr(self, "_by_range", None) is not None:
            return self._by_range
        import numpy as np

        ancestors: Dict[str, set] = defaultdict(set)
        stacks: Dict[int, list] = defaultdict(list)
        for name, s, e, _, tid in sorted(self.events["ranges"], key=lambda r: (r[4], r[1])):
            stack = stacks[tid]
            while stack and stack[-1][0] <= s:
                stack.pop()
            ancestors[name] |= {n for _, n in stack}
            stack.append((e, name))
        ops = self.events["ops"]
        out: Dict[str, float] = defaultdict(float)
        if not ops or not self.events["projections"]:
            self._by_range = out
            return out
        k_s = np.array([o[1] for o in ops], dtype=np.int64)
        k_e = np.array([o[2] for o in ops], dtype=np.int64)
        by_name: Dict[str, list] = defaultdict(list)
        for name, s, e in self.events["projections"]:
            by_name[name].append((s, e))
        names = sorted(by_name)
        best = np.full(len(ops), np.iinfo(np.int64).max, dtype=np.int64)
        owner = np.full(len(ops), -1, dtype=np.int64)
        for j, name in enumerate(names):
            iv = np.array(sorted(by_name[name]), dtype=np.int64)
            # the latest projection of this name starting at or before the op
            idx = np.searchsorted(iv[:, 0], k_s, side="right") - 1
            ok = idx >= 0
            idx = np.where(ok, idx, 0)
            inside = ok & (iv[idx, 1] >= k_e)
            length = np.where(inside, iv[idx, 1] - iv[idx, 0], np.iinfo(np.int64).max)
            better = length < best
            best = np.where(better, length, best)
            owner = np.where(better, j, owner)
        dur = (k_e - k_s) / 1e9
        for j, name in enumerate(names):
            sec = float(dur[owner == j].sum())
            for n in {name} | ancestors[name]:
                out[n] += sec
        self._by_range = out
        return out

    def busy_intervals(self) -> List[Tuple[int, int]]:
        spans = sorted((s, e) for _, s, e, _ in self.events["ops"] if e > s)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        by_op: Dict[str, float] = defaultdict(float)
        for name, s, e, _ in self.events["ops"]:
            by_op[name[:160]] += (e - s) / 1e9
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
                if busy[i + 1][0] > busy[i][1]]
        ranges = sorted((s, e, name) for name, s, e, _, _ in self.events["ranges"])
        starts = [s for s, _, _ in ranges]
        longest = max((e - s for s, e, _ in ranges), default=0)
        by_host: Dict[str, float] = defaultdict(float)
        for gs, ge in gaps:
            best, label = 0, "no harness range open (HTTP, JSON, batcher, tokenize)"
            i = bisect.bisect_left(starts, ge) - 1
            while i >= 0 and starts[i] >= gs - longest:
                s, e, name = ranges[i]
                overlap = min(e, ge) - max(s, gs)
                if overlap > best:
                    best, label = overlap, f"host in {name}"
                i -= 1
            by_host[label] += (ge - gs) / 1e9
        gaps_out = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in gaps_out]}
