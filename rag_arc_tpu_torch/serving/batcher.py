"""Adaptive query micro-batching.

The port's own copy of ``rag_arc_tpu/serving/batcher.py``, its behaviour
unchanged, so the port imports nothing of the JAX package.

The TPU answers a 512-query batch in barely more time than a single query
(one score matmul amortizes the corpus read across the batch — see
bench.py), so serving throughput hinges on coalescing concurrent requests
into one dispatch. ``QueryBatcher`` coalesces adaptively:

- **Idle fast path**: when nothing is in flight, a request dispatches
  IMMEDIATELY (batch of 1) — single-query p50 is the device latency, not
  device + wait window. This is what makes the <5 ms latency target
  reachable through the serving stack at low load.
- **In-flight coalescing**: while a batch is running on the device,
  arrivals queue; the queue flushes as soon as the running batch returns
  (continuous batching) or when ``max_wait_ms`` / ``max_batch`` is hit,
  whichever comes first. Under load the dispatch size converges to the
  arrival rate × device latency — throughput approaches the device's
  batched QPS with no tuning.

(SURVEY.md §7 "throughput vs latency batching" hard part.)

Each submit stamps its queries with the time and the submitting
request's span context (``utils/tracing.py``); the batch thread records
their ``batcher.wait`` spans (submit to the start of their batch) and
runs the batch under its batch id and the ids of the requests it serves.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from rag_arc_tpu_torch.utils import tracing

logger = logging.getLogger(__name__)


@dataclass
class _Submit:
    """One submit call: when, and under which request's span."""

    t_ns: int = field(default_factory=time.time_ns)
    ctx: Optional[tuple] = field(default_factory=tracing.current)


@dataclass
class _Pending:
    query: str
    kwargs: tuple
    origin: _Submit = field(default_factory=_Submit)
    event: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None


class QueryBatcher:
    """Thread-safe request coalescer around a batched answer function."""

    def __init__(
        self,
        batch_fn: Callable[[Sequence[str]], List[Any]],
        max_batch: int = 128,
        max_wait_ms: float = 3.0,
    ):
        self.batch_fn = batch_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._lock = threading.Lock()
        self._queue: List[_Pending] = []
        self._flusher: Optional[threading.Timer] = None
        # generation counter: a timer that FIRED but lost the lock race to
        # a flush must not later flush a NEWER coalescing window early —
        # cancel() is a no-op on an already-fired Timer
        self._flusher_gen = 0
        self._in_flight = 0
        self.stats: Dict[str, float] = {
            "requests": 0,
            "batches": 0,
            "max_batch_seen": 0,
        }

    def submit(self, query: str, **kwargs: Any) -> Any:
        """Blocking: returns this query's result when its batch completes."""
        pending = _Pending(query=query, kwargs=tuple(sorted(kwargs.items())))
        try:
            hash(pending.kwargs)
        except TypeError as exc:
            # reject unhashable kwargs (e.g. JSON "k": [10]) HERE, on the
            # offending request — inside _run_batch it would kill the
            # worker before any event is set and hang the whole batch
            raise TypeError(f"batcher kwargs must be hashable: {exc}") from exc
        with self._lock:
            self._queue.append(pending)
            self.stats["requests"] += 1
            if len(self._queue) >= self.max_batch or self._in_flight == 0:
                # full batch, or the device is idle — don't make a lone
                # request pay the coalescing window for nothing
                self._flush_locked()
            elif self._flusher is None:
                self._flusher_gen += 1
                self._flusher = threading.Timer(
                    self.max_wait_s, self._flush_timer, args=(self._flusher_gen,)
                )
                self._flusher.daemon = True
                self._flusher.start()
        pending.event.wait()
        if pending.error is not None:
            raise pending.error
        return pending.result

    def submit_many(self, queries: Sequence[str], **kwargs: Any) -> List[Any]:
        """Blocking bulk submit: enqueue every query in ONE lock
        acquisition so concurrent multi-query requests coalesce into
        shared device batches (a 64-query HTTP request that ran as its
        own device batch cost nearly as much chip time as a full 512
        batch — serving_stage_timings r5: every /batch request became a
        B=64 search). Full max_batch slices flush immediately; the
        remainder waits for the coalescing window like any other request.
        Results come back in query order; the first failed batch raises."""
        kw = tuple(sorted(kwargs.items()))
        try:
            hash(kw)
        except TypeError as exc:
            raise TypeError(f"batcher kwargs must be hashable: {exc}") from exc
        origin = _Submit()
        pendings = [_Pending(query=q, kwargs=kw, origin=origin) for q in queries]
        if not pendings:
            return []
        with self._lock:
            self._queue.extend(pendings)
            self.stats["requests"] += len(pendings)
            while len(self._queue) >= self.max_batch:
                self._flush_locked(cap=self.max_batch)
            if self._queue and (self._in_flight == 0):
                self._flush_locked()
            elif self._queue and self._flusher is None:
                self._flusher_gen += 1
                self._flusher = threading.Timer(
                    self.max_wait_s, self._flush_timer,
                    args=(self._flusher_gen,),
                )
                self._flusher.daemon = True
                self._flusher.start()
        for p in pendings:
            p.event.wait()
        for p in pendings:
            if p.error is not None:
                raise p.error
        return [p.result for p in pendings]

    def _flush_timer(self, gen: int) -> None:
        with self._lock:
            if gen != self._flusher_gen:
                return  # superseded: another flush consumed this window
            self._flush_locked()

    def _flush_locked(self, cap: Optional[int] = None) -> None:
        # invalidate ANY armed-or-fired timer for the window being flushed
        self._flusher_gen += 1
        if self._flusher is not None:
            self._flusher.cancel()
            self._flusher = None
        if cap is None or cap >= len(self._queue):
            batch, self._queue = self._queue, []
        else:
            batch, self._queue = self._queue[:cap], self._queue[cap:]
        if not batch:
            return
        self.stats["batches"] += 1
        self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], len(batch))
        self._in_flight += 1
        try:
            threading.Thread(
                target=self._run_batch, args=(batch,), daemon=True
            ).start()
        except BaseException as exc:  # noqa: BLE001 — thread exhaustion
            # roll back and fail the batch: leaving _in_flight raised with
            # no _run_batch to decrement it would hang these callers AND
            # permanently disable the idle fast path
            self._in_flight -= 1
            for p in batch:
                p.error = exc
                p.event.set()

    def _run_batch(self, batch: List[_Pending]) -> None:
        batch_id = tracing.new_id()
        started = time.time_ns()
        origins: Dict[int, List[Any]] = {}
        for p in batch:
            origins.setdefault(id(p.origin), [p.origin, 0])[1] += 1
        for origin, n in origins.values():
            tracing.record_span("batcher.wait", origin.t_ns, started, parent=origin.ctx,
                                batch=batch_id, queries=n)
        requests = [o.ctx[1] for o, _ in origins.values() if o.ctx is not None]
        try:
            # group by kwargs signature so mixed-parameter requests stay
            # correct
            groups: Dict[tuple, List[_Pending]] = {}
            for p in batch:
                groups.setdefault(p.kwargs, []).append(p)
            for kwargs_sig, group in groups.items():
                try:
                    with tracing.bind(request=requests, batch=batch_id):
                        results = self.batch_fn(
                            [p.query for p in group], **dict(kwargs_sig)
                        )
                    if len(results) != len(group):
                        # zip would silently hand trailing callers None
                        raise RuntimeError(
                            f"batch_fn returned {len(results)} results "
                            f"for {len(group)} queries"
                        )
                    for p, r in zip(group, results):
                        p.result = r
                except BaseException as exc:  # noqa: BLE001 — per request
                    for p in group:
                        p.error = exc
                finally:
                    for p in group:
                        p.event.set()
        except BaseException as exc:  # noqa: BLE001 — never hang a caller
            for p in batch:
                if not p.event.is_set():
                    p.error = exc
                    p.event.set()
        finally:
            # _in_flight MUST decrement on every exit path, or the idle
            # fast path is disabled forever and callers hang
            with self._lock:
                self._in_flight -= 1
                if self._queue and self._in_flight == 0:
                    # continuous batching: the device just went idle —
                    # drain everything that coalesced while we were running
                    self._flush_locked()
