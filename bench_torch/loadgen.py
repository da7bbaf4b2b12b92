"""The load generator: a process of its own that imports only the standard
library (no torch), so its clients share no interpreter lock with the
server they load.

Run as ``python3 loadgen.py SPEC.json OUT.json``. The spec gives the port,
the window's start and end (``time.time()`` seconds), the request bodies
(pre-serialised JSON, one per line in ``bodies``), and the loop:

- ``closed``: ``clients`` connections; client c sends ``order[c]`` (body
  indices, cycled) one after another until the window ends. A request is
  due when it is sent.
- ``open``: request i is due at ``due[i]`` and carries body ``order[i]``;
  a dispatcher hands each due request to an idle connection's worker, or
  starts one more. Lateness is send time minus due time.

Every request records due, sent and done times, its status and the
number of results; the responses listed in ``keep`` are written out in
full. Requests still in flight when the window ends are waited for, up to
``drain_s`` seconds; one that never answers is recorded with status 0.
"""

from __future__ import annotations

import http.client
import json
import queue
import sys
import threading
import time


def _request(conn, body: bytes):
    conn.request("POST", "/batch", body, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, resp.read()


class _Recorder:
    def __init__(self, keep):
        self.keep = set(keep)
        self.lock = threading.Lock()
        self.records = {}
        self.kept = {}

    def add(self, rid, body_idx, due, sent, done, status, data):
        n = -1
        if status == 200:
            try:
                parsed = json.loads(data)
                n = len(parsed["results"])
                if rid in self.keep:
                    with self.lock:
                        self.kept[rid] = parsed
            except (ValueError, KeyError, TypeError):
                status, n = -1, -1
        elif rid in self.keep:
            with self.lock:
                self.kept[rid] = {"error": data[:500].decode("utf-8", "replace")}
        with self.lock:
            self.records[rid] = [body_idx, due, sent, done, status, n]


def _connect(spec):
    return http.client.HTTPConnection("127.0.0.1", spec["port"], timeout=spec["timeout_s"])


def closed_loop(spec, bodies, rec: _Recorder) -> None:
    start, end = spec["start"], spec["end"]
    orders = spec["order"]

    def client(c: int) -> None:
        conn = _connect(spec)
        mine, i = orders[c], 0
        try:
            while time.time() < start:
                time.sleep(min(0.001, max(0.0, start - time.time())))
            while True:
                sent = time.time()
                if sent >= end:
                    return
                body_idx = mine[i % len(mine)]
                rid = c * 1_000_000 + i
                i += 1
                try:
                    status, data = _request(conn, bodies[body_idx])
                except (OSError, http.client.HTTPException) as exc:
                    status, data = 0, repr(exc).encode()
                    conn.close()
                    conn = _connect(spec)
                rec.add(rid, body_idx, sent, sent, time.time(), status, data)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(len(orders))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(spec["end"] - time.time() + spec["drain_s"])


def open_loop(spec, bodies, rec: _Recorder) -> None:
    due, order = spec["due"], spec["order"]
    work: "queue.Queue" = queue.Queue()
    idle = [0]
    lock = threading.Lock()
    threads = []

    def worker() -> None:
        conn = _connect(spec)
        try:
            while True:
                item = work.get()
                if item is None:
                    return
                rid, d = item
                sent = time.time()
                try:
                    status, data = _request(conn, bodies[order[rid]])
                except (OSError, http.client.HTTPException) as exc:
                    status, data = 0, repr(exc).encode()
                    conn.close()
                    conn = _connect(spec)
                rec.add(rid, order[rid], d, sent, time.time(), status, data)
                with lock:
                    idle[0] += 1
        finally:
            conn.close()

    def spawn() -> None:
        t = threading.Thread(target=worker, daemon=True)
        t.start()
        threads.append(t)

    for _ in range(spec["clients"]):
        spawn()
    with lock:
        idle[0] = spec["clients"]
    for rid, d in enumerate(due):
        wait = d - time.time()
        if wait > 0:
            time.sleep(wait)
        with lock:
            busy = idle[0] == 0
            if not busy:
                idle[0] -= 1
        if busy:
            spawn()  # every connection is waiting for an answer: one more
        work.put((rid, d))
    for _ in threads:
        work.put(None)
    deadline = spec["end"] + spec["drain_s"]
    for t in threads:
        t.join(max(0.0, deadline - time.time()))


def main(argv) -> int:
    spec_path, out_path = argv[1], argv[2]
    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    with open(spec["bodies"], "rb") as f:
        bodies = f.read().split(b"\n")
    rec = _Recorder(spec.get("keep", []))
    if spec["loop"] == "closed":
        closed_loop(spec, bodies, rec)
    else:
        open_loop(spec, bodies, rec)
    with rec.lock:
        if spec["loop"] == "open":
            for rid, d in enumerate(spec["due"]):  # never answered: status 0
                rec.records.setdefault(rid, [spec["order"][rid], d, None, None, 0, -1])
        out = {"records": rec.records, "kept": rec.kept}
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
