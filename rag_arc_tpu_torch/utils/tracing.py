"""Tracing and per-stage timing (the port's own copy of
``rag_arc_tpu/utils/tracing.py``, so the port imports nothing of the JAX
package; the tracer below is the port's own singleton).

A process-wide stage timer with percentile summaries and a
decorator/context-manager API. The JAX package's ``device_profile``
(a ``jax.profiler`` trace, called nowhere) is not copied.

Usage::

    from rag_arc_tpu_torch.utils.tracing import stage, get_tracer

    with stage("retrieval.dense"):
        ...
    get_tracer().summary()   # {stage: {count, mean_ms, p50_ms, p99_ms}}
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np


class StageTracer:
    """Thread-safe accumulator of per-stage wall-time samples."""

    def __init__(self, max_samples_per_stage: int = 4096):
        self._lock = threading.Lock()
        self._samples: Dict[str, List[float]] = defaultdict(list)
        self.max_samples = max_samples_per_stage

    def record(self, stage_name: str, seconds: float) -> None:
        with self._lock:
            samples = self._samples[stage_name]
            if len(samples) >= self.max_samples:
                samples.pop(0)
            samples.append(seconds)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def traced(self, name: Optional[str] = None) -> Callable:
        def deco(fn: Callable) -> Callable:
            stage_name = name or f"{fn.__module__}.{fn.__qualname__}"

            @functools.wraps(fn)
            def wrapper(*args: Any, **kwargs: Any):
                with self.stage(stage_name):
                    return fn(*args, **kwargs)

            return wrapper

        return deco

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            out = {}
            for name, samples in self._samples.items():
                if not samples:
                    continue
                arr = np.asarray(samples) * 1e3
                out[name] = {
                    "count": len(samples),
                    "mean_ms": float(arr.mean()),
                    "p50_ms": float(np.percentile(arr, 50)),
                    "p99_ms": float(np.percentile(arr, 99)),
                    "total_ms": float(arr.sum()),
                }
            return out

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()


_TRACER = StageTracer()


def get_tracer() -> StageTracer:
    return _TRACER


def stage(name: str):
    """Module-level shorthand: ``with stage("embed.forward"): ...``"""
    return _TRACER.stage(name)


def traced(name: Optional[str] = None) -> Callable:
    return _TRACER.traced(name)
