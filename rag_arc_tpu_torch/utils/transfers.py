"""Batched device→host readbacks for streamed dispatch (counterpart of
``rag_arc_tpu/utils/transfers.py``).

A stream of dispatched batches fetched one by one synchronizes with the
card once per batch. A :class:`TransferPool` collects every pending tree
of tensors registered during a stream's dispatch phase and reads them ALL
back in one flush at the first ``result`` demand: on CUDA, each tensor is
copied with ``non_blocking=True`` into pinned host memory on one side
stream, and the flush waits on one event, so the stream pays one
synchronization instead of one per batch. CPU tensors are plainly copied.

Usage (a streamed driver does this):

    with transfer_pool():
        fetches = [retriever.dispatch_batch(b, k=k) for b in batches]
        results = [f() for f in fetches]   # 1 flush, not len(batches)

Dispatchers opt in by checking :func:`current_pool` at dispatch time;
with no active pool they read back directly, so single-shot calls are
unchanged. Lazily launched device work (the BM25 device-query coalescer)
registers at launch time instead: callers expose a ``prime()`` hook so a
streaming driver can force every lazy launch BEFORE the first ``result``
demand and keep the flush count at one.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_current: contextvars.ContextVar[Optional["TransferPool"]] = (
    contextvars.ContextVar("rag_arc_torch_transfer_pool", default=None)
)


def _leaves(tree: Any, out: List[torch.Tensor]) -> None:
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            _leaves(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _leaves(t, out)


def _rebuild(tree: Any, host: Dict[int, np.ndarray]) -> Any:
    if isinstance(tree, torch.Tensor):
        return host[id(tree)]
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(t, host) for t in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(v, host) for k, v in tree.items()}
    return tree


def device_get(trees: Any) -> Any:
    """Host numpy copies of every tensor in ``trees`` (tuples, lists and
    dicts of tensors; other leaves pass through), with one synchronization
    for all the CUDA tensors among them."""
    leaves: List[torch.Tensor] = []
    _leaves(trees, leaves)
    host: Dict[int, np.ndarray] = {}
    by_device: Dict[torch.device, List[torch.Tensor]] = {}
    for t in leaves:
        if t.device.type == "cuda":
            by_device.setdefault(t.device, []).append(t)
        else:
            host[id(t)] = t.detach().to("cpu", copy=True).numpy()
    for dev, ts in by_device.items():
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            done = torch.cuda.Event()
            pinned = []
            with torch.cuda.stream(side):
                for t in ts:
                    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    buf.copy_(t.detach(), non_blocking=True)
                    pinned.append(buf)
                done.record(side)
            done.synchronize()
        for t, buf in zip(ts, pinned):
            host[id(t)] = buf.numpy()
    return _rebuild(trees, host)


class TransferPool:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: Dict[int, Any] = {}
        self._done: Dict[int, Any] = {}
        self._flushing = False
        self._ctr = 0
        self.flushes = 0

    def register(self, tree: Any) -> int:
        """Record a device tree for the next flush; returns a handle."""
        with self._lock:
            handle = self._ctr
            self._ctr += 1
            self._pending[handle] = tree
            return handle

    def result(self, handle: int) -> Any:
        """Host copy of a registered tree. The first demand flushes every
        pending tree in ONE :func:`device_get`; results cache until their
        (single) owner claims them. A demand racing another thread's
        in-flight flush waits for it instead of fetching twice."""
        with self._cond:
            while True:
                if handle in self._done:
                    return self._done.pop(handle)
                if handle in self._pending:
                    keys = list(self._pending)
                    trees = [self._pending.pop(kk) for kk in keys]
                    self._flushing = True
                    break
                if self._flushing:
                    # our tree rides a flush another thread started
                    self._cond.wait()
                    continue
                raise KeyError(f"unknown transfer handle {handle}")
        try:
            fetched = device_get(trees)
        except BaseException:
            with self._cond:  # re-park so owners see a clean error, not a hang
                for kk, tt in zip(keys, trees):
                    self._pending[kk] = tt
                self._flushing = False
                self._cond.notify_all()
            raise
        with self._cond:
            for kk, vv in zip(keys, fetched):
                self._done[kk] = vv
            self.flushes += 1
            self._flushing = False
            self._cond.notify_all()
            return self._done.pop(handle)


def current_pool() -> Optional[TransferPool]:
    return _current.get()


@contextlib.contextmanager
def transfer_pool():
    """Activate a :class:`TransferPool` for dispatches made inside the
    block. Fetch closures capture the pool, so they keep working after
    the block exits."""
    pool = TransferPool()
    token = _current.set(pool)
    try:
        yield pool
    finally:
        _current.reset(token)
