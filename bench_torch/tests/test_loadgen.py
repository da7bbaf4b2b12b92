"""The load generator against a stub server: the schedule, the counts,
and failures counted as such. The generator imports no torch."""

import json
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

from bench_torch.harness import HERE, percentile


class _Stub(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    delay_s = 0.01

    def log_message(self, *a):
        pass

    def do_POST(self):  # noqa: N802
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        time.sleep(self.delay_s)
        if "fail" in body["queries"][0]:
            code, out = 500, {"error": "asked to fail"}
        else:
            code, out = 200, {"results": [[{"id": q}] for q in body["queries"]]}
        data = json.dumps(out).encode()
        self.send_response(code)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture
def stub():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    server.daemon_threads = True
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield server.server_port
    server.shutdown()
    server.server_close()


def _run(tmp_path: Path, spec: dict, bodies) -> dict:
    (tmp_path / "bodies.txt").write_bytes(b"\n".join(json.dumps(b).encode() for b in bodies))
    spec = dict(spec, bodies=str(tmp_path / "bodies.txt"), timeout_s=30.0, drain_s=5.0)
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    probe = ("import runpy, sys; sys.argv = sys.argv[1:]; "
             "runpy.run_path(sys.argv[0], run_name='__main__'); "
             "assert 'torch' not in sys.modules and 'numpy' not in sys.modules")
    r = subprocess.run([sys.executable, "-c", probe, str(HERE / "loadgen.py"),
                        str(tmp_path / "spec.json"), str(tmp_path / "out.json")],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    return json.loads((tmp_path / "out.json").read_text())


def test_open_loop_schedule_and_counts(stub, tmp_path):
    start = time.time() + 0.3
    due = [start + 0.05 * i for i in range(20)]
    bodies = [{"queries": [f"q{i}"]} for i in range(19)] + [{"queries": ["fail"]}]
    out = _run(tmp_path, {"port": stub, "loop": "open", "clients": 2, "start": start,
                          "end": start + 1.0, "due": due, "order": list(range(20)),
                          "keep": [3, 19]}, bodies)
    recs = {int(k): v for k, v in out["records"].items()}
    assert sorted(recs) == list(range(20))
    for rid, (body, d, sent, done, status, n) in recs.items():
        assert body == rid and d == pytest.approx(due[rid])
        assert sent >= d - 1e-3 and sent - d < 0.05  # sent on time
        assert done - d >= 0.01  # the stub's delay, timed from the due time
        assert (status, n) == ((500, -1) if rid == 19 else (200, 1))
    assert out["kept"]["3"]["results"] == [[{"id": "q3"}]]
    assert "error" in out["kept"]["19"]


def test_open_loop_adds_connections_when_all_wait(stub, tmp_path):
    _Stub.delay_s = 0.3
    try:
        start = time.time() + 0.3
        due = [start + 0.01 * i for i in range(10)]  # 10 due well inside one answer
        out = _run(tmp_path, {"port": stub, "loop": "open", "clients": 1, "start": start,
                              "end": start + 0.2, "due": due, "order": list(range(10)),
                              "keep": []}, [{"queries": [f"q{i}"]} for i in range(10)])
    finally:
        _Stub.delay_s = 0.01
    lat = [v[3] - v[1] for v in out["records"].values()]
    assert max(lat) < 0.55  # none waited for another's answer
    assert percentile(lat, 50) >= 0.3


def test_closed_loop_counts(stub, tmp_path):
    start = time.time() + 0.3
    bodies = [{"queries": [f"c{c}b{b}", "x"]} for c in range(3) for b in range(4)]
    order = [[c * 4 + b for b in range(4)] for c in range(3)]
    out = _run(tmp_path, {"port": stub, "loop": "closed", "clients": 3, "start": start,
                          "end": start + 0.5, "order": order, "keep": [1_000_000]}, bodies)
    recs = {int(k): v for k, v in out["records"].items()}
    per_client = {c: sorted(r % 1_000_000 for r in recs if r // 1_000_000 == c) for c in range(3)}
    for c, seq in per_client.items():
        assert seq == list(range(len(seq))) and len(seq) >= 10  # one after another, cycled
        for i in seq:
            body, d, sent, done, status, n = recs[c * 1_000_000 + i]
            assert body == order[c][i % 4] and d == sent and status == 200 and n == 2
            assert start <= sent < start + 0.5
    assert out["kept"]["1000000"]["results"][0] == [{"id": "c1b0"}]


def test_percentile_counts_failures_as_missing():
    assert percentile([1.0, 2.0, float("inf")], 50) == 2.0
    assert percentile([1.0, float("inf")], 95) == float("inf")
