"""One run of one cell: build, warm up, measure, check, report.

Everything particular to a cell is found by name: the workload's entry in
``BENCHMARK.json``, its configuration (``configs/<config>.json``, whose
``system`` names a module of ``systems/``), its traffic mix
(``traffic/<traffic>.json``) and one reader per per-layer metric
(``metrics/<metric>.py``, a ``read(run)`` that returns a number or None).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from bench_torch import traffic as traffic_mod
from bench_torch.trace import DeviceTrace, Spans

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "flax", "rag_arc_tpu")


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def cell(spec: dict, name: str, bench_dir: Path = HERE):
    """(workload entry, configuration, traffic mix) of the named cell."""
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    cfg = load_json(bench_dir.parent / cfg_entry["file"])
    tr = load_json(bench_dir / "traffic" / f"{wl['traffic']}.json")
    return wl, cfg, tr


def metrics_for(spec: dict, name: str) -> tuple:
    """(end-to-end metric entries, per-layer metric entries) the cell reports."""
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench_dir: Path = HERE) -> Callable:
    return load_module(bench_dir / "metrics" / f"{metric}.py", f"bench_metric_{metric}").read


def system_class(cfg: dict, bench_dir: Path = HERE):
    mod = load_module(bench_dir / "systems" / f"{cfg['system']}.py", f"bench_system_{cfg['system']}")
    return mod.SYSTEM


@dataclass
class Run:
    """What the per-layer readers read."""

    kind: str
    system: object
    window_s: float
    window: tuple  # (start, end), time.time() seconds
    spans: Spans
    trace: Optional[DeviceTrace] = None
    counters: Dict[str, float] = field(default_factory=dict)
    latencies_ms: list = field(default_factory=list)  # open loop: each request's, in due order

    def in_window(self, name: str) -> list:
        """The items of a timed record (``spans.record(name, (t, items))``)
        made inside the window, flattened."""
        lo, hi = self.window
        return [x for t, items in self.spans.records[name] if lo <= t <= hi for x in items]


def process_start_time() -> float:
    """This process's start, wall clock, from /proc (Linux)."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime", encoding="ascii") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules
                  if m in FORBIDDEN or any(m.startswith(f + ".") for f in FORBIDDEN))


def percentile(values, q: float) -> float:
    a = np.asarray(values, dtype=np.float64)
    if np.isinf(a).any():
        a = np.where(np.isinf(a), np.finfo(np.float64).max, a)
        v = float(np.percentile(a, q))
        return math.inf if v >= np.finfo(np.float64).max / 2 else v
    return float(np.percentile(a, q))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# -- served cells -----------------------------------------------------------------


def _serve(pipeline):
    from rag_arc_tpu_torch.serving.app import make_server

    server = make_server(pipeline, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def _http_warmup(port: int, bodies) -> None:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        for body in bodies:
            conn.request("POST", "/batch", body, {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise RuntimeError(f"warm-up request answered {resp.status}: {data[:300]!r}")
    finally:
        conn.close()


def run_served(sysm, tr: dict, seed: int, seconds: float, traced: bool, torch, device,
               run_dir: Path, t_process: float, log=_log):
    n_check = int(tr["check_requests"])
    stream = traffic_mod.served_stream(tr, seed, seconds, n_check)
    t = time.time()
    sysm.warmup_served(tr)
    sysm.stages["warmup"] = time.time() - t
    log("set-up stages (s): " + ", ".join(f"{k} {v:.2f}" for k, v in sysm.stages.items()))
    server, thread = _serve(sysm.pipeline)
    port = server.server_port
    spans = Spans()
    try:
        _http_warmup(port, [stream.bodies[-1], stream.bodies[-2]])
        if traced:
            sysm.instrument(spans, "served")
        bodies_path = run_dir / "bodies.txt"
        bodies_path.write_bytes(b"\n".join(stream.bodies))
        lead = 1.5  # the client process starts and connects before the window
        start = time.time() + lead
        end = start + seconds
        spec = {"port": port, "start": start, "end": end, "bodies": str(bodies_path),
                "loop": stream.loop, "clients": stream.clients, "order": stream.order,
                "keep": stream.keep, "timeout_s": 600.0, "drain_s": 60.0}
        if stream.due is not None:
            spec["due"] = [start + d for d in stream.due]
        (run_dir / "spec.json").write_text(json.dumps(spec))
        out_path = run_dir / "loadgen_out.json"
        batcher = sysm.pipeline.batcher
        stats0 = dict(batcher.stats)
        tracer = DeviceTrace(torch) if traced else None
        if tracer:
            tracer.prepare()
        proc = subprocess.Popen([sys.executable, str(HERE / "loadgen.py"),
                                 str(run_dir / "spec.json"), str(out_path)],
                                stdin=subprocess.DEVNULL)
        try:
            setup_s = start - t_process
            time.sleep(max(0.0, start - time.time()))
            if tracer:
                tracer.start()
            time.sleep(max(0.0, end - time.time()))
            if tracer:
                tracer.stop()
            stats1 = dict(batcher.stats)
            rc = proc.wait(timeout=seconds + 180)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if rc != 0:
            raise RuntimeError(f"the load generator exited with {rc}")
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(60)
    res = load_json(out_path)
    records = {int(k): v for k, v in res["records"].items()}
    kept = {int(k): v for k, v in res["kept"].items()}
    qpr = int(tr["queries_per_request"])
    ok = {rid: r for rid, r in records.items() if r[4] == 200 and r[5] == qpr}
    if stream.loop == "closed":
        attempted = len(records)
        failed = attempted - len(ok)
        done = [r for r in ok.values() if r[3] <= end]
        e2e = {"queries_per_s": qpr * len(done) / seconds}
        late = [0.0]
    else:
        attempted = len(stream.due)
        failed = attempted - len(ok)
        lat = [(records[r][3] - records[r][1]) * 1e3 if r in ok else math.inf
               for r in sorted(records)]
        e2e = {"request_p95_ms": percentile(lat, 95), "request_p50_ms": percentile(lat, 50)}
        late = [(r[2] - r[1]) * 1e3 for r in records.values() if r[2] is not None]
        log(f"request latency from the due time (ms): p50 {e2e['request_p50_ms']!r}, p90 "
            f"{percentile(lat, 90)!r}, p95 {e2e['request_p95_ms']!r}, p99 {percentile(lat, 99)!r}")
    e2e["setup_s"] = setup_s
    log(f"requests: sent {attempted}, succeeded {len(ok)}, failed {failed}; generator "
        f"lateness mean {np.mean(late):.3f} ms, max {np.max(late):.3f} ms")
    tenth = seconds / 10
    slices = np.bincount([min(9, int((r[3] - start) // tenth)) for r in ok.values()
                          if start <= r[3] <= end], minlength=10)
    log(f"answered requests by tenth of the window: {slices.tolist()}")
    if stream.loop == "open":
        ids = sorted(records)
        slow = sorted(range(len(lat)), key=lambda i: -lat[i])[:5]
        log("slowest requests (due s into the window, ms): "
            + ", ".join(f"{stream.due[ids[i]]:.2f} {lat[i]:.1f}" for i in slow))
    bq, bb = (stats1["requests"] - stats0["requests"], stats1["batches"] - stats0["batches"])
    run = Run(stream.loop, sysm, seconds, (start, end), spans, tracer,
              {"batcher_queries": bq, "batcher_batches": bb})
    if stream.loop == "open":
        run.latencies_ms = lat
    if traced:
        words = [w for rid in ok if records[rid][3] <= end
                 for w in stream.words[records[rid][0]]]
        flops = sysm.query_flops(words)
        if sysm.reranker is not None:
            flops += sysm.rerank_flops(run.in_window("pairs"))
        run.counters["model_flops"] = flops
    queries_of = {rid: stream.queries[records[rid][0]] for rid in kept if rid in records}
    answers = sysm.served_answers(kept, queries_of)
    missing_kept = len(set(stream.keep) - set(kept))
    answers = answers[:4] + (answers[4] + missing_kept,)
    return run, e2e, attempted, failed, peak, answers


# -- the ingest cell -------------------------------------------------------------------


def run_ingest(sysm, tr: dict, seed: int, seconds: float, traced: bool, torch, device,
               t_process: float, log=_log):
    n_batches = int(tr["pool_batches"])
    batches, lengths = traffic_mod.ingest_batches(tr, seed, n_batches)
    warm, _ = traffic_mod.ingest_batches(tr, seed + 1, int(tr["warm_batches"]))
    t = time.time()
    sysm.warmup_ingest(warm)
    sysm.stages["warmup"] = time.time() - t
    log("set-up stages (s): " + ", ".join(f"{k} {v:.2f}" for k, v in sysm.stages.items()))
    spans = Spans()
    if traced:
        sysm.instrument(spans, "ingest")
    tracer = DeviceTrace(torch) if traced else None
    if tracer:
        tracer.prepare()
    done_docs, attempted, failed, added = 0, 0, 0, []
    start = time.time()
    setup_s = start - t_process
    end = start + seconds
    if tracer:
        tracer.start()
    i = 0
    while time.time() < end:
        cycle, b = divmod(i, n_batches)
        batch = [(f"{doc_id}.{cycle}", text) for doc_id, text in batches[b]] if cycle \
            else batches[b]
        attempted += 1
        try:
            n = sysm.ingest(batch)
        except Exception as exc:  # noqa: BLE001 — a failed call is counted, the job goes on
            failed += 1
            log(f"add_documents failed: {exc!r}")
            n = 0
        if time.time() <= end and n == len(batch):
            done_docs += n
            added.append((b, batch))
        i += 1
    if tracer:
        tracer.stop()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    e2e = {"docs_per_s": done_docs / seconds, "setup_s": setup_s}
    log(f"ingest: {attempted} add_documents calls of {tr['batch_docs']}, {failed} failed, "
        f"{done_docs} documents in the window")
    run = Run("ingest", sysm, seconds, (start, end), spans, tracer, {"docs": done_docs})
    size = int(tr["batch_docs"])
    if traced:
        words = [int(lengths[b * size + j]) for b, batch in added for j in range(len(batch))]
        run.counters["model_flops"] = sysm.passage_flops(words)
    rng = np.random.default_rng(seed % (1 << 63) + 11)
    flat = [(doc_id, text, int(lengths[b * size + j]))
            for b, batch in added for j, (doc_id, text) in enumerate(batch)]
    n_check = min(int(tr["check_docs"]), len(flat))
    pick = rng.choice(len(flat), size=n_check, replace=False) if n_check else []
    sample = [flat[int(j)] for j in pick]
    if flat:  # the longest document added is always checked
        longest = max(flat, key=lambda x: x[2])
        if longest not in sample:
            sample = [longest] + sample[:-1] if sample else [longest]
    return run, e2e, attempted, failed, peak, sample


# -- one run ---------------------------------------------------------------------------


def run_cell(spec: dict, name: str, seed: int, seconds: float, traced: bool, *, device,
             root: Path, cfg: Optional[dict] = None, tr: Optional[dict] = None,
             hook: Optional[Callable] = None, t_process: Optional[float] = None,
             log=_log) -> dict:
    """Run the named cell and return the result line's object."""
    import tempfile

    import torch

    t_process = process_start_time() if t_process is None else t_process
    wl, cfg0, tr0 = cell(spec, name)
    cfg, tr = cfg or cfg0, tr or tr0
    device = torch.device(device)
    e2e_entries, layer_entries = metrics_for(spec, name)
    cache_dir = root / ".bench_cache"
    cache_dir.mkdir(parents=True, exist_ok=True)
    run_dir = Path(tempfile.mkdtemp(prefix="bench_run_"))
    try:
        sysm = system_class(cfg)(cfg, seed, device, cache_dir, run_dir, torch)
        if tr["loop"] == "ingest":
            sysm.build_ingest()
        else:
            sysm.build_served()
        if hook is not None:
            hook(sysm)
        if tr["loop"] == "ingest":
            run, e2e, attempted, failed, peak, sample = run_ingest(
                sysm, tr, seed, seconds, traced, torch, device, t_process, log)
            answers = sysm.ingest_answers(sample)
        else:
            run, e2e, attempted, failed, peak, answers = run_served(
                sysm, tr, seed, seconds, traced, torch, device, run_dir, t_process, log)
        layer_values = {}
        if traced:
            for m in layer_entries:
                v = reader(m["name"])(run)
                if v is not None:
                    layer_values[m["name"]] = v
        busy = run.trace.busy_s() if run.trace else None
        breakdown = run.trace.breakdown() if run.trace else None
        sysm.free()
        t_check = time.time()
        if tr["loop"] == "ingest":
            checks = sysm.evaluate_ingest(sample, answers)
        else:
            checks = sysm.evaluate_served(*answers)
        log(f"reference check took {time.time() - t_check:.1f} s")
    finally:
        import shutil

        shutil.rmtree(run_dir, ignore_errors=True)
    limits = cfg["limits"]
    compared = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    if traced:
        metrics = {m["name"]: {"value": layer_values[m["name"]], "unit": m["unit"]}
                   for m in layer_entries if m["name"] in layer_values}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in e2e_entries}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = busy
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = breakdown
    out["checks"] = compared
    return out
