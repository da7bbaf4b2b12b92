"""The port's tracing: request-scoped spans and per-stage summaries.

``stage(name, **attrs)`` is the one entry point. Every call feeds the
per-stage summary that ``GET /stats`` serves (count, mean, p50, p99 and
total ms over a stage's last 4,096 samples, and the sums of its counts).
While tracing is on, it also appends one ``Span`` to an in-memory ring:
its name, start and end in ``time.time_ns()`` (the clock the torch
profiler stamps its events with, so spans line up with a device trace
by time), its id and its parent's (carried in a ``ContextVar``), the
request it serves (or, for a batch, the list of requests) and the batch
id, the thread, and ``attrs``: counts such as tokens, slots or queries,
which the body may add to the dict the ``with`` yields.

Tracing is on after ``enable()``, and while a torch profiler records.
``torch._C._autograd._profiler_enabled()`` reads the calling thread's
profiler state only, and reads False in every thread when the profiler
runs with ``profile_all_threads``; so the module follows the profiler's
own entry points (``_enable_profiler`` / ``_disable_profiler``, which
``torch.profiler`` and direct callers reach) and the flag that
``torch.profiler.profile`` sets. Spans open no profiler range.

``spans(since_ns, until_ns)`` returns the spans that ended inside a
window. Nothing is written anywhere else. The JAX package keeps its own
``rag_arc_tpu/utils/tracing.py``; nothing here imports it.

Usage::

    from rag_arc_tpu_torch.utils.tracing import stage, get_tracer

    with stage("encoder.pack") as span:
        ...
        span["tokens"] = n_real
    get_tracer().summary()   # {stage: {count, mean_ms, p50_ms, p99_ms, total_ms, counts}}
"""

from __future__ import annotations

import collections
import contextvars
import functools
import itertools
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

# spans kept while tracing is on: a 60 s window at ~2,000 spans a second
RING_SPANS = 1 << 17
SAMPLES_PER_STAGE = 4096


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: Optional[int]
    request: Any  # a request id, a batch's list of them, or None
    batch: Optional[int]
    thread: int
    attrs: Dict[str, Any]


# (span id, request, batch) of the innermost open span of this context
_CURRENT: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "rag_arc_tpu_torch_span", default=None
)
_IDS = itertools.count(1)
_PROFILER = [False]  # a profiler session opened through the hooks below


def new_id() -> int:
    """A process-wide unique id: spans, requests and batches draw from it."""
    return next(_IDS)


def _follow_profiler() -> None:
    """Wrap the profiler's enable/disable entry points so that a session
    started in any thread, with any configuration, turns tracing on."""
    ag = torch._C._autograd
    enable, disable = ag._enable_profiler, ag._disable_profiler
    if hasattr(enable, "__wrapped__"):
        return  # this module was imported again

    @functools.wraps(enable)
    def enable_profiler(*args, **kwargs):
        out = enable(*args, **kwargs)
        _PROFILER[0] = True
        return out

    @functools.wraps(disable)
    def disable_profiler(*args, **kwargs):
        _PROFILER[0] = False
        return disable(*args, **kwargs)

    ag._enable_profiler, ag._disable_profiler = enable_profiler, disable_profiler


_follow_profiler()


class _Stage:
    """The context manager ``stage()`` returns."""

    __slots__ = ("tracer", "name", "attrs", "request", "batch", "start", "ctx", "parent",
                 "token")

    def __init__(self, tracer: "StageTracer", name: str, attrs: Dict[str, Any]):
        self.tracer, self.name, self.attrs = tracer, name, attrs
        self.request = attrs.pop("request", None)
        self.batch = attrs.pop("batch", None)
        self.token = None

    def __enter__(self) -> Dict[str, Any]:
        if self.tracer.active():
            parent, request, batch = _CURRENT.get() or (None, None, None)
            self.ctx = (next(_IDS), request if self.request is None else self.request,
                        batch if self.batch is None else self.batch)
            self.parent = parent
            self.token = _CURRENT.set(self.ctx)
        self.start = time.time_ns()
        return self.attrs

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        self.tracer.record(self.name, (end - self.start) / 1e9, self.attrs)
        if self.token is not None:
            _CURRENT.reset(self.token)
            span_id, request, batch = self.ctx
            self.tracer._ring.append((self.name, self.start, end, span_id, self.parent,
                                      request, batch, threading.get_ident(), self.attrs))


class StageTracer:
    """Thread-safe per-stage samples, and the span ring."""

    def __init__(self, max_samples_per_stage: int = SAMPLES_PER_STAGE,
                 ring_spans: int = RING_SPANS):
        self._lock = threading.Lock()
        self.max_samples = max_samples_per_stage
        self._samples: Dict[str, collections.deque] = {}
        self._ring: collections.deque = collections.deque(maxlen=ring_spans)  # Span fields
        self._enabled = False

    # -- switches ----------------------------------------------------------------

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def active(self) -> bool:
        return self._enabled or _PROFILER[0] or _autograd_profiler._is_profiler_enabled

    # -- recording ---------------------------------------------------------------

    def record(self, name: str, seconds: float, attrs: Optional[Dict[str, Any]] = None) -> None:
        """One summary sample (no span)."""
        with self._lock:
            samples = self._samples.get(name)
            if samples is None:
                samples = self._samples[name] = collections.deque(maxlen=self.max_samples)
            samples.append((seconds, attrs))

    def stage(self, name: str, **attrs: Any) -> _Stage:
        """``with tracer.stage(name, **attrs) as attrs: ...``; ``request=``
        and ``batch=`` set the span's request and batch for it and its
        children, instead of inheriting them."""
        return _Stage(self, name, attrs)

    def record_span(self, name: str, start_ns: int, end_ns: int, *,
                    parent: Optional[tuple] = None, batch: Optional[int] = None,
                    **attrs: Any) -> None:
        """A span timed elsewhere (e.g. a queue wait, stamped at submit and
        closed on another thread). ``parent`` is what ``current()`` read
        where the span began."""
        self.record(name, (end_ns - start_ns) / 1e9, attrs)
        if not self.active():
            return
        parent_id, request, parent_batch = parent if parent is not None else (None, None, None)
        self._ring.append((name, start_ns, end_ns, next(_IDS), parent_id, request,
                           parent_batch if batch is None else batch, threading.get_ident(),
                           attrs))

    # -- reading -----------------------------------------------------------------

    def spans(self, since_ns: Optional[int] = None, until_ns: Optional[int] = None) -> List[Span]:
        """The spans in the ring that ended inside [since_ns, until_ns]."""
        lo = -1 if since_ns is None else since_ns
        hi = float("inf") if until_ns is None else until_ns
        return [Span._make(s) for s in self._ring.copy() if lo <= s[2] <= hi]

    def summary(self) -> Dict[str, Dict[str, Any]]:
        """Per stage: count, mean/p50/p99/total ms, and ``counts``: its
        integer attrs summed and its string attrs tallied by value
        (``"path=direct"``), over the same samples."""
        with self._lock:
            kept = {name: list(s) for name, s in self._samples.items() if s}
        out = {}
        for name, samples in kept.items():
            arr = np.asarray([s for s, _ in samples]) * 1e3
            counts: Dict[str, int] = collections.defaultdict(int)
            for _, attrs in samples:
                for key, value in (attrs or {}).items():
                    if isinstance(value, str):
                        counts[f"{key}={value}"] += 1
                    elif isinstance(value, (int, np.integer)) and not isinstance(value, bool):
                        counts[key] += int(value)
            out[name] = {
                "count": len(samples),
                "mean_ms": float(arr.mean()),
                "p50_ms": float(np.percentile(arr, 50)),
                "p99_ms": float(np.percentile(arr, 99)),
                "total_ms": float(arr.sum()),
                "counts": dict(counts),
            }
        return out

    def reset(self) -> None:
        """Drop the summary samples and the ring."""
        with self._lock:
            self._samples.clear()
        self._ring.clear()


class _Bind:
    """Sets the request and batch of the spans opened inside it."""

    __slots__ = ("value", "token")

    def __init__(self, request: Any, batch: Optional[int]):
        ctx = _CURRENT.get()
        self.value = (ctx[0] if ctx is not None else None, request, batch)

    def __enter__(self) -> None:
        self.token = _CURRENT.set(self.value)

    def __exit__(self, *exc) -> None:
        _CURRENT.reset(self.token)


_TRACER = StageTracer()


def get_tracer() -> StageTracer:
    return _TRACER


def stage(name: str, **attrs: Any) -> _Stage:
    """Module-level shorthand: ``with stage("store.fetch"): ...``"""
    return _Stage(_TRACER, name, attrs)


def record_span(name: str, start_ns: int, end_ns: int, **kwargs: Any) -> None:
    _TRACER.record_span(name, start_ns, end_ns, **kwargs)


def bind(request: Any = None, batch: Optional[int] = None) -> _Bind:
    """``with bind(request=[...], batch=id): ...`` on a thread that serves
    requests opened elsewhere (a batcher's batch thread)."""
    return _Bind(request, batch)


def current() -> Optional[tuple]:
    """(span id, request, batch) of the innermost open span, or None."""
    return _CURRENT.get()


def enable() -> None:
    _TRACER.enable()


def disable() -> None:
    _TRACER.disable()


def spans(since_ns: Optional[int] = None, until_ns: Optional[int] = None) -> List[Span]:
    return _TRACER.spans(since_ns, until_ns)
