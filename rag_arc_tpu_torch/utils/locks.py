"""Reader-writer lock for index mutation vs. search.

The port's own copy of ``rag_arc_tpu/utils/locks.py``, its behaviour unchanged, so
the port imports nothing of the JAX package.

The serving frontend (``serving/app.py``) handles ``/add`` and ``/query``
on concurrent threads, but ``DeviceFlatIndex.add`` donates its input
buffers to XLA (``donate_argnums``) — a search that reads ``index.emb``
while an add donates the same buffer raises a use-after-donate error.
Searches may run concurrently with each other (they only read device
arrays), so a full mutex would cost throughput; this RW lock lets any
number of readers in while writers get exclusive access.

Writer preference: once a writer is waiting, new readers block, so a
steady query stream cannot starve adds. Neither side is reentrant —
callers take the lock only at public entry points.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class RWLock:
    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer_active = False
        self._writers_waiting = 0

    @contextmanager
    def read(self):
        with self._cond:
            while self._writer_active or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer_active or self._readers:
                    self._cond.wait()
                self._writer_active = True
            finally:
                # ALWAYS decrement: an exception while waiting (e.g.
                # KeyboardInterrupt) would otherwise leak the counter and
                # block every future reader forever
                self._writers_waiting -= 1
                self._cond.notify_all()
        try:
            yield
        finally:
            with self._cond:
                self._writer_active = False
                self._cond.notify_all()
