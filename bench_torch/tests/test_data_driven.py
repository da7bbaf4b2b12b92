"""A later change adds a configuration, a traffic mix and a per-layer
metric as files and entries only: the harness finds them by name, and no
file that was there is edited."""

import hashlib
import json
import shutil
from pathlib import Path

from bench_torch import harness
from bench_torch.tests.tiny import BENCH, ROOT


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    bench = tmp_path / "bench_torch"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)

    cfg = json.loads((bench / "configs" / "msmarco_e5base.json").read_text())
    cfg.update(name="msmarco_e5small", encoder=dict(cfg["encoder"], hidden_size=384,
                                                   num_attention_heads=6, intermediate_size=1536))
    (bench / "configs" / "msmarco_e5small.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "msmarco_batch8.json").write_text(json.dumps({
        "loop": "open", "arrivals": "poisson", "rate_per_s": 40.0,
        "clients": 16, "queries_per_request": 8,
        "query_words": {"mean": 5.96, "sigma": 0.45, "cap": 30}, "k": 10,
        "response": "full", "check_requests": 32}))
    (bench / "metrics" / "json_host_ms.batch8.py").write_text(
        '"""Host ms a request serializing JSON."""\n\n\ndef read(run):\n'
        '    return run.counters.get("json_ms")\n')
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "msmarco_e5small", "source": "https://example.org/e5-small",
                            "file": "bench_torch/configs/msmarco_e5small.json", "reduced": []})
    spec["workloads"].append({"name": "msmarco_small.batch8", "config": "msmarco_e5small",
                              "traffic": "msmarco_batch8", "chips": 1,
                              "why": "8-query requests"})
    p50 = next(m for m in spec["end_to_end"] if m["name"] == "request_p50_ms")
    p50["workloads"].append("msmarco_small.batch8")
    spec["per_layer"].append({"name": "json_host_ms.batch8", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "HTTP + JSON",
                              "moves": "request_p50_ms", "workloads": ["msmarco_small.batch8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    wl, got_cfg, tr = harness.cell(spec, "msmarco_small.batch8", bench)
    assert got_cfg["encoder"]["hidden_size"] == 384 and tr["arrivals"] == "poisson"
    e2e, layer = harness.metrics_for(spec, "msmarco_small.batch8")
    assert [m["name"] for m in e2e] == ["request_p50_ms", "setup_s"]
    assert [m["name"] for m in layer] == ["json_host_ms.batch8"]
    run = harness.Run("open", None, 1.0, (0.0, 1.0), None, counters={"json_ms": 0.25})
    assert harness.reader("json_host_ms.batch8", bench)(run) == 0.25
    assert harness.system_class(got_cfg, bench).__name__ == "DenseRag"
    # the new mix is data for the one generator
    from bench_torch import traffic
    stream = traffic.served_stream(tr, 5, 10.0, 4)
    assert len(stream.due) == 400 and all(len(q) == 8 for q in stream.queries)
    assert 0.0 == stream.due[0] < stream.due[-1] < 10.0

    after = _digests(tmp_path)
    changed = [p for p in before if before[p] != after.get(p)]
    assert changed == ["BENCHMARK.json"]  # entries added to it; no other file touched
