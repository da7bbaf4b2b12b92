"""The port's benchmark: one run of one cell.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this
directory and the program (``rag_arc_tpu_torch``). The run builds the
cell's configuration, warms up its shapes, measures for ``--seconds``,
checks what the timed path answered against the plain references, and
prints one JSON object as the last line of standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones. It exits non-zero, printing no result, without a CUDA
device (or with fewer than the cell asks for), and when the JAX package,
``jax`` or ``flax`` was imported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(ROOT / ".bench_cache" / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False).stdout.strip()
        return out.splitlines()[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench_torch import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    wl, _, _ = harness.cell(spec, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"a CUDA device is needed ({wl['chips']} for {args.workload}); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    card = power_limit()
    print(f"card: {card}", file=sys.stderr, flush=True)
    result = harness.run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda:0", root=ROOT)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules were imported: {bad}", file=sys.stderr)
        return 3
    for name, m in result["metrics"].items():
        print(f"metric {name} {m['value']!r} {m['unit']} ({card})", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
