"""Kernel A/B probe: the fused top-k kernel against the two-level search
and its producers, on one corpus and one query set.

Counterpart of the JAX package's ``tools/kernel_probe.py``, with its flags
and its configs:

    python -m rag_arc_tpu_torch.tools.kernel_probe [--n 2000000] [--d 768]
        [--b 512] [--k 10] [--reps 5] [--stream 8] [--configs 'JSON;JSON']
        [--device cuda] [--seed 0]

Data follows the JAX tool's recipe, made on the device from a
``torch.Generator``: N(0, 1) rows normalized, queries that are corpus rows
plus 0.1 N(0, 1) noise, normalized; rows padded to a multiple of 4096 with
dead rows; the corpus in bf16, its int8 form by ``quantize_rows_blocked``
(one scale per 32 rows). Recall@k is against the f32 top-k of the first
128 queries of batch 0, computed in row chunks.

Each config (a JSON object with ``kind`` and its parameters) prints one
JSON line: ``cfg``, ``compile_s`` (the first call, builds included),
``recall``, ``ms_min``, ``ms_median``, ``ms_all`` (per batch, over
``--reps`` streams of ``--stream`` batches, CUDA events around each stream
and a synchronize; host clock on the CPU) and ``qps_at_median``. A config
that fails prints ``{"cfg", "error"}`` and the sweep goes on.

Kinds: ``fused`` (``fused_mips_topk``; ``skip_tiles`` and ``packed``
default on, as in the JAX tool), ``two_level`` and ``stream``
(``two_level_topk`` with ``producer`` "stream", "stream_piped" or "scan"),
``i8`` and ``i8_stream`` (``two_level_topk_i8``), ``dma_only`` (the
corpus-stream floor, ``dtype`` "int8" for the int8 corpus), ``xla_scan``
(the scan producer alone), ``p1_stream`` (the stream producer alone,
``pipelined`` for the piped one) and ``select_only`` (select + rescore on a
precomputed pass 1). The JAX tool times the stream producer under
``xla_scan`` and its ``p1_stream`` falls through to ``two_level``; here
each kind runs its own path.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from rag_arc_tpu_torch.ops.corpus_stream import corpus_stream
from rag_arc_tpu_torch.ops.fused_mips import fused_mips_topk
from rag_arc_tpu_torch.ops.subtile_max import subtile_max
from rag_arc_tpu_torch.ops.two_level import (
    produce,
    quantize_rows_blocked,
    select_rescore,
    subtile_max_scan,
    two_level_topk,
    two_level_topk_i8,
)

DEFAULT_CONFIGS = [
    {"kind": "fused", "tile_n": 2048, "q_block": 256},
    {"kind": "two_level", "tile_n": 2048, "q_block": 512, "g": 128},
    {"kind": "two_level", "tile_n": 2048, "q_block": 256, "g": 128},
    {"kind": "two_level", "tile_n": 1024, "q_block": 512, "g": 128},
    {"kind": "two_level", "tile_n": 4096, "q_block": 256, "g": 128},
    {"kind": "two_level", "tile_n": 2048, "q_block": 512, "g": 256},
]
KINDS = ("fused", "two_level", "stream", "i8_stream", "i8", "dma_only", "xla_scan",
         "p1_stream", "select_only")
# kinds whose output is not a top-k: no recall (as in the JAX tool)
NO_RECALL = ("p1_stream", "select_only", "dma_only", "xla_scan")
ROW_PAD = 4096
QUANT_BLOCK = 32
ORACLE_QUERIES = 128
_ORACLE_ROWS = 1 << 18


def make_data(n: int, d: int, b: int, stream: int, k: int, seed: int,
              device: torch.device, int8: bool = True) -> Dict:
    """The probe's corpus (bf16, padded, dead rows zero), its int8 form,
    the query batches and the f32 oracle's top-k ids."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_pad = -(-n // ROW_PAD) * ROW_PAD
    x = torch.randn((n_pad, d), generator=gen, device=device)
    x[n:] = 0.0
    x /= torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-12)
    q_idx = torch.randint(0, n, (b * stream,), generator=gen, device=device)
    queries = x[q_idx] + 0.1 * torch.randn((b * stream, d), generator=gen, device=device)
    queries /= torch.linalg.norm(queries, dim=1, keepdim=True)
    sub = queries[: min(ORACLE_QUERIES, b)]
    best_s = torch.full((sub.shape[0], 0), 0.0, device=device)
    best_p = torch.full((sub.shape[0], 0), 0, dtype=torch.int64, device=device)
    for start in range(0, n, _ORACLE_ROWS):  # f32 exact scores, row chunks
        stop = min(start + _ORACLE_ROWS, n)
        s = sub @ x[start:stop].T
        s, p = torch.topk(s, min(k, stop - start), dim=1)
        best_s, order = torch.topk(torch.cat([best_s, s], 1), min(k, stop), dim=1)
        best_p = torch.gather(torch.cat([best_p, p + start], 1), 1, order)
    data = {
        "emb": x.to(torch.bfloat16),
        "valid": torch.arange(n_pad, device=device) < n,
        "sqnorm": torch.ones(n_pad, device=device),
        "batches": [queries[i * b : (i + 1) * b].contiguous() for i in range(stream)],
        "exact": best_p.cpu().numpy(),
    }
    if int8:
        data["emb_i8"], data["row_scale"] = quantize_rows_blocked(x, QUANT_BLOCK)
    return data


def make_fn(cfg: Dict, data: Dict, k: int) -> Callable:
    """The call a config times: query batch → (scores or None, result)."""
    kind = cfg.get("kind")
    emb, valid, sqnorm = data["emb"], data["valid"], data["sqnorm"]
    if kind == "fused":
        return lambda q: fused_mips_topk(
            q, emb, valid, sqnorm, k, tile_n=cfg["tile_n"],
            q_block=cfg.get("q_block", 256), skip_tiles=cfg.get("skip_tiles", True),
            packed=cfg.get("packed", True))
    if kind == "two_level":
        return lambda q: two_level_topk(q, emb, valid, k, g=cfg.get("g", 128),
                                        tile_n=cfg["tile_n"])
    if kind == "stream":
        return lambda q: two_level_topk(q, emb, valid, k, g=cfg.get("g", 32),
                                        tile_n=cfg["tile_n"],
                                        producer=cfg.get("producer", "scan"))
    if kind in ("i8", "i8_stream"):
        g = cfg.get("g", 32)
        producer = cfg.get("producer", "scan") if kind == "i8_stream" else "stream"
        # the JAX tool's i8 search takes per-row scales; its certified i8
        # stream is exact under block scales wherever g divides the block
        block = kind == "i8_stream" and QUANT_BLOCK % g == 0
        return lambda q: two_level_topk_i8(
            q, data["emb_i8"], data["row_scale"], valid, k, g=g, block_scales=block,
            producer=producer, tile_n=cfg["tile_n"])
    if kind == "dma_only":
        src = data["emb_i8"] if cfg.get("dtype") == "int8" else emb
        return lambda q: (None, corpus_stream(src)[:1, :1])
    if kind == "xla_scan":
        return lambda q: (None, subtile_max_scan(q.to(emb.dtype), emb, valid,
                                                 cfg.get("g", 16), cfg["tile_n"]))
    if kind == "p1_stream":
        producer = "stream_piped" if cfg.get("pipelined", False) else "stream"
        return lambda q: (None, produce(producer, q.to(emb.dtype), emb, valid,
                                        cfg.get("g", 32), cfg["tile_n"]))
    if kind == "select_only":
        g = cfg.get("g", 32)
        sub_pre = subtile_max(data["batches"][0].to(emb.dtype), emb, valid, g)
        return lambda q: select_rescore(q.to(emb.dtype), emb, valid, sub_pre, k, g)
    raise ValueError(f"unknown kind {kind!r}; one of {KINDS}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probe(cfg: Dict, data: Dict, k: int, reps: int,
          device: torch.device) -> Tuple[Dict, Optional[Tuple[np.ndarray, np.ndarray]]]:
    """Runs one config: its JSON line and, for a top-k kind, the (scores,
    ids) of batch 0."""
    fn = make_fn(cfg, data, k)
    batches = data["batches"]
    t0 = time.perf_counter()
    out = fn(batches[0])
    _sync(device)
    compile_s = time.perf_counter() - t0
    recall, top = None, None
    if cfg["kind"] not in NO_RECALL:
        ids = out[1].cpu().numpy()
        top = (out[0].cpu().numpy(), ids)
        exact = data["exact"]
        got = ids[: len(exact)]
        recall = float(np.mean([len(set(got[i].tolist()) & set(exact[i].tolist())) / k
                                for i in range(len(exact))]))
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for q in batches:
                fn(q)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / len(batches))
        else:
            t1 = time.perf_counter()
            for q in batches:
                fn(q)
            times.append((time.perf_counter() - t1) * 1e3 / len(batches))
    ms = np.asarray(times)
    b = batches[0].shape[0]
    line = {
        "cfg": cfg,
        "compile_s": compile_s,
        "recall": recall,
        "ms_min": float(ms.min()),
        "ms_median": float(np.median(ms)),
        "ms_all": [float(t) for t in ms],
        "qps_at_median": b / float(np.median(ms)) * 1e3,
    }
    return line, top


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2_000_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--b", type=int, default=512)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--stream", type=int, default=8, help="batches per timed stream")
    ap.add_argument("--configs", type=str, default="",
                    help="';'-separated JSON objects; the default sweep when empty")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def parse_configs(spec: str) -> List[Dict]:
    if not spec:
        return [dict(c) for c in DEFAULT_CONFIGS]
    return [json.loads(s) for s in spec.split(";") if s.strip()]


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("kernel_probe: no CUDA device (pass --device cpu for the plain versions)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    configs = parse_configs(args.configs)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    int8 = any(c.get("kind") in ("i8", "i8_stream") or c.get("dtype") == "int8"
               for c in configs)
    data = make_data(args.n, args.d, args.b, args.stream, args.k, args.seed, device, int8)
    for cfg in configs:
        try:
            line, _ = probe(cfg, data, args.k, args.reps, device)
        except Exception as exc:  # noqa: BLE001 — the sweep goes on
            line = {"cfg": cfg, "error": str(exc)[:300]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
