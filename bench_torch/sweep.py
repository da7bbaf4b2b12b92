"""Find an open-loop cell's knee: the highest rate at which completions
keep pace with arrivals and no request fails.

    python3 bench_torch/sweep.py --workload <cell> --rates 4,8,12 [--seconds 10]

One process builds the cell once and runs one window a rate (the cell's
traffic at that rate, seed fixed). A line a rate: requests, failures, p50,
p95, and the median latency of the last fifth of the window against the
first fifth (a backlog that grows shows as a ratio well above 1). The cell
runs at four fifths of the knee; a later change that moves the knee finds
it again with this script.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def sweep(spec, name, rates, seconds, seed, device, root, cfg=None, tr=None, log=print):
    import tempfile

    import torch

    from bench_torch import harness

    _, cfg0, tr0 = harness.cell(spec, name)
    cfg, tr = cfg or cfg0, tr or tr0
    device = torch.device(device)
    out = []
    with tempfile.TemporaryDirectory(prefix="bench_sweep_") as run_dir:
        sysm = harness.system_class(cfg)(cfg, seed, device, root / ".bench_cache",
                                         Path(run_dir), torch)
        sysm.build_served()
        for rate in rates:
            t_rate = dict(tr, rate_per_s=float(rate))
            run, e2e, attempted, failed, _, _ = harness.run_served(
                sysm, t_rate, seed, seconds, False, torch, device, Path(run_dir), time.time(),
                log=lambda m: None)
            lat = run.latencies_ms
            fifth = max(1, len(lat) // 5)
            first = statistics.median(lat[:fifth])
            last = statistics.median(lat[-fifth:])
            row = {"rate_per_s": rate, "requests": attempted, "failed": failed,
                   "p50_ms": e2e["request_p50_ms"], "p95_ms": e2e["request_p95_ms"],
                   "first_fifth_ms": first, "last_fifth_ms": last,
                   "growth": last / first if first > 0 and math.isfinite(last) else math.inf,
                   "batch_queries": run.counters["batcher_queries"] / max(1, run.counters["batcher_batches"])}
            log(json.dumps(row))
            out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    from bench_torch import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    sweep(spec, args.workload, [float(r) for r in args.rates.split(",")], args.seconds,
          args.seed, "cuda:0", ROOT, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
