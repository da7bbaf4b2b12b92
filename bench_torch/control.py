"""The correctness control: the plain references put in the program's place
and computed one precision below the configuration's (bf16 → fp8 e4m3 with
per-tensor scales), held by the same comparison a run makes. Its numbers
set the upper reading of each limit; they must fail it.

    python3 bench_torch/control.py --workload <cell> --seeds 1,2,3 [--seconds S]

Run on the card at the cell's own size (no program is built; the checked
queries or documents are those a run with that seed and window would
check). Prints one line of numbers a seed and the limits.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_numbers(spec: dict, name: str, seed: int, seconds: float, device,
                    cfg=None, tr=None, cache_dir=None) -> dict:
    import numpy as np
    import torch

    from bench_torch import harness, traffic
    from bench_torch.reference import fp8_mm

    _, cfg0, tr0 = harness.cell(spec, name)
    cfg, tr = cfg or cfg0, tr or tr0
    device = torch.device(device)
    sysm = harness.system_class(cfg)(cfg, seed, device, cache_dir or ROOT / ".bench_cache",
                                     cache_dir or ROOT / ".bench_cache", torch)
    if tr["loop"] == "ingest":
        batches, lengths = traffic.ingest_batches(tr, seed, 8)
        rng = np.random.default_rng(seed % (1 << 63) + 11)
        flat = [(i, t, int(lengths[b * len(batch) + j]))
                for b, batch in enumerate(batches) for j, (i, t) in enumerate(batch)]
        pick = rng.choice(len(flat), size=min(int(tr["check_docs"]), len(flat)), replace=False)
        sample = [flat[int(j)] for j in pick]
        answers = sysm.control_ingest_answers(sample, fp8_mm)
        return sysm.evaluate_ingest(sample, answers)
    stream = traffic.served_stream(tr, seed, seconds, int(tr["check_requests"]))
    if stream.loop == "closed":
        by_client = {c: o for c, o in enumerate(stream.order)}
        bodies = [by_client[rid // 1_000_000][rid % 1_000_000] for rid in stream.keep]
    else:
        bodies = list(stream.keep)
    qs = [q for b in bodies for q in stream.queries[b]]
    positions, contents, probs = sysm.control_answers(qs, fp8_mm)
    return sysm.evaluate_served(qs, positions, contents, probs, 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    from bench_torch import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    seconds = args.seconds or spec["run_seconds"]
    _, cfg, _ = harness.cell(spec, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        nums = control_numbers(spec, args.workload, seed, seconds, "cuda:0")
        print(json.dumps({"workload": args.workload, "seed": seed, "control": nums,
                          "limits": cfg["limits"], "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
