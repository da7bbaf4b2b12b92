#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines and times:

  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: compile the four CUDA sources of ``rag_arc_tpu_torch/csrc`` for
     sm_90a, one ``nvcc`` each, in parallel (nvcc's register / shared-memory
     report is printed);
  3. kernels against their plain PyTorch versions on the card (N = 262,144,
     d = 768, g = 16, ~3% dead rows), then compared again and timed in
     turns at B = 512, N = 2M:
     - ``subtile_max``: bf16 B in {1, 7, 128, 512}, f32 B = 64;
     - its l2 mode: bf16 B in {7, 512}, f32 B = 64;
     - ``subtile_max_i8``: block scales B in {1, 7, 128, 512}, per-row
       scales B = 64, exactly equal; at N = 2M both scale modes;
     - ``rope_prep`` at the reranker shape (B = 64, L = 512, nh/nkv 16/8,
       D = 128, bf16, left-padded positions, norm folded in), ragged,
       nh = nkv, D = 64 and f32 cases; timed in turns at the reranker shape;
     - ``flash_attention`` at B = 64, L = 512, H = 16, D = 128 bf16 with
       random left-pad lengths, every row compared (pads included), and
       L in {64, 200}, D = 64, f32; timed in turns at the reranker shape;
  4. index: a 2,000,000 x 768 corpus, its queries and their f32 exact
     top-10 oracle, shared by three indexes, each searched in batches of
     512 queries (k = 10) with ids checked against the plain producer's:
     - bf16 cosine, 30 batches: QPS, p50 batch time, recall@10;
     - bf16 l2 over the first 2^20 rows, 5 batches, recall@10 against an
       f32 l2 oracle;
     - int8 cosine with the default int4 residual refine and kf_mult 2, 30
       batches: QPS, p50, recall@10, bytes on the card, host quantization
       time, and one B = 1 search whose peak memory must stay under the
       index's resident bytes + 1 GiB (no f32 copy of the corpus);
  5. end to end: ``TorchEncoderEmbeddings`` at the full 768 x 12 config
     (seeded random weights) feeding ``TorchVectorStore.from_texts``:
     - bf16 with 262,144 generated documents; 4 batches of 512 verbatim
       document texts through ``batch_similarity_search_with_score`` and 8
       single queries through ``as_retriever().invoke``;
     - int8 with the first 16,384 of them; one batch of 512 verbatim texts
       and 4 single queries; then the store saved as a snapshot and loaded
       into a fresh store, with arrays and results compared bit for bit;
  6. rerank model: ``Qwen3LM`` at Qwen3-0.6B widths (28 x 1024, 16/8 heads
     of 128, vocab 151,936), bf16, seeded N(0, 0.02) weights; ``last_logits``
     on B = 64 x L = 512 random ids timed (pairs/s, ms per 50-candidate
     query, MFU against 989 TFLOP/s), one layer's stage times, the kernel
     path held against the einsum path on the same weights, and an f32
     check at full width and 2 layers;
  7. retrieve -> rerank: the top 50 of the bf16 e2e store for 8 query texts
     through ``CrossEncoderReranker.from_causal_lm(qwen3, ...)
     .rerank_batch(k=10)``, checked (candidates, sorted, scores in [0, 1],
     order against the einsum path) and counted (both kernels launch once
     per layer); then one ``rerank_batch`` through the default
     ``CrossEncoderReranker()`` (768 x 12 causal).

Every check that fails ends the run with a non-zero exit. Without a CUDA
card it exits non-zero at once. The second-to-last line is a JSON object
describing each kernel; the last line is the run's JSON status.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SEED = 0
K = 10
G = 16
DIM = 768
KERNEL_N = 262_144
KERNEL_CASES = [("bf16", 1), ("bf16", 7), ("bf16", 128), ("bf16", 512), ("f32", 64)]
L2_CASES = [("bf16", 7), ("bf16", 512), ("f32", 64)]
I8_CASES = [(True, 1), (True, 7), (True, 128), (True, 512), (False, 64)]  # (block scales, B)
TIMING_N = 2_000_000
CORPUS_N = 2_000_000
BATCH = 512
N_BATCHES = 30
L2_N = 1 << 20
L2_BATCHES = 5
ORACLE_QUERIES = 128
N_DOCS = 262_144
I8_DOCS = 16_384
DOC_VOCAB = 30_000
STORE_CAPACITY = 2_097_152
E2E_BATCHES = 4
N_SINGLE = 8
I8_SINGLE = 4
TOL = 1e-4  # bf16 products are exact in f32: only the summation order differs
# the reranker: Qwen3-0.6B widths at bench.py::bench_rerank's B and L
RERANK_B = 64
RERANK_L = 512
RERANK_REPS = 5
H100_BF16_PEAK = 989e12  # dense bf16 FLOP/s, NVIDIA's data sheet (SXM, 700 W)
H100_INT8_PEAK = 1979e12  # dense int8 OP/s, the same sheet
H100_F32_PEAK = 67e12  # f32 FLOP/s outside the tensor cores, the same sheet
H100_HBM = 3.35e12  # HBM3 bytes/s, the same sheet
# the kernel probe's kernels: the pipelined producer, the fused top-k
# (tile_n 2048 as the probe's fused config) and the corpus stream
PIPED_CASES = [("bf16", 1), ("bf16", 7), ("bf16", 512), ("f32", 64), ("int8", 7),
               ("int8", 512)]
FUSED_CASES = [(1, False, False), (7, True, True), (130, True, False), (512, False, True),
               (512, True, True)]  # (B, skip_tiles, packed)
FUSED_TILE = 2048
PROBE_N = 2_000_000
PROBE_STREAM = 8
PROBE_REPS = 3
PROBE_CONFIGS = [  # the probe's default sweep comes first
    {"kind": "stream", "tile_n": 2048, "g": 16, "producer": "stream"},
    {"kind": "stream", "tile_n": 2048, "g": 16, "producer": "stream_piped"},
    {"kind": "stream", "tile_n": 2048, "g": 16, "producer": "scan"},
    {"kind": "fused", "tile_n": 2048, "skip_tiles": True, "packed": True},
    {"kind": "fused", "tile_n": 2048, "skip_tiles": False, "packed": False},
    {"kind": "dma_only", "tile_n": 2048},
    {"kind": "dma_only", "tile_n": 2048, "dtype": "int8"},
    {"kind": "p1_stream", "tile_n": 2048, "g": 16},
    {"kind": "p1_stream", "tile_n": 2048, "g": 16, "pipelined": True},
]
ROPE_CASES = [  # (B, L, nh, nkv, D, dtype)
    (RERANK_B, RERANK_L, 16, 8, 128, "bf16"), (3, 77, 16, 8, 128, "bf16"),
    (4, 128, 8, 8, 128, "bf16"), (4, 96, 8, 4, 64, "bf16"), (4, 100, 16, 8, 128, "f32"),
]
FLASH_CASES = [  # (B, H, L, D, dtype), random left-pad lengths
    (RERANK_B, 16, RERANK_L, 128, "bf16"), (8, 16, 64, 128, "bf16"),
    (8, 16, 200, 128, "bf16"), (4, 8, 300, 64, "bf16"), (2, 4, 160, 128, "f32"),
    (2, 4, 96, 64, "f32"),
]
# (atol, rtol). rope_prep runs the plain version's f32 arithmetic up to FMA
# contraction and rounds once: one bf16 ulp (2^-7 relative at most), f32
# rounding noise. flash_attention rounds exp(s - running max) to bf16 for
# P·V where the plain version rounds exp(s - final max): two bf16 ulps at
# |out| < 4 plus 1%; at f32 only the summation order differs.
ROPE_TOL = {"bf16": (1e-2, 8e-3), "f32": (1e-5, 1e-6)}
FLASH_TOL = {"bf16": (3e-2, 1e-2), "f32": (1e-5, 1e-5)}
# kernel path against the einsum path on the same weights: the two round
# bf16 at different points (models/qwen3.py), 28 layers deep
LOGIT_BOUND = 0.1
P_BOUND = 0.05
F32_B, F32_L, F32_BOUND = 4, 256, 1e-4  # f32, full width, 2 layers
RERANK_QUERIES = 8
RERANK_CANDIDATES = 50

CARD = ""
ROOT = Path(__file__).resolve().parent


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def report(msg: str) -> None:
    """A measured line, tagged with the card it was measured on."""
    print(f"  {msg}  [{CARD}]", flush=True)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call over ``reps`` calls (CUDA events)."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def in_turns(kernel, plain, name: str, ops: float, unit: str, nbytes: float,
             bytes_label: str = "of corpus") -> dict:
    """Time kernel and plain version in turns (plain, kernel, kernel,
    plain) and report both, with the kernel's rates: ``ops`` per call in
    ``unit`` (ops / 1e12 per second) and ``nbytes`` per call in GB/s."""
    p1 = cuda_ms(plain, 3)
    k1 = cuda_ms(kernel, 10)
    k2 = cuda_ms(kernel, 10)
    p2 = cuda_ms(plain, 3)
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    report(f"{name}: kernel {k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms "
           f"(CUDA events; in turns plain, kernel, kernel, plain); kernel "
           f"{ops / kernel_ms / 1e9:.1f} {unit}, {nbytes / kernel_ms / 1e6:.1f} GB/s "
           f"{bytes_label}")
    return {"ms": kernel_ms, "plain_ms": plain_ms}


def bound(ops: float, peak: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the peak rate for their type and the bytes (each input read once,
    each output written once) over the HBM rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / H100_HBM * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def library_ms(fn, name: str) -> float:
    """Mean ms of one PyTorch call that computes a kernel's function (a
    yardstick the port never calls): one call outside the window, then 10."""
    import torch

    fn()
    torch.cuda.synchronize()
    ms = cuda_ms(fn, 10)
    report(f"{name}: library call {ms:.3f} ms (CUDA events, mean of 10)")
    return ms


def unit_rows(gen, n: int, d: int, dtype, device):
    import torch

    x = torch.rand((n, d), generator=gen, device=device) - 0.5
    return (x / torch.linalg.norm(x, dim=1, keepdim=True)).to(dtype)


def phase_environment(torch) -> None:
    global CARD
    phase("environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    CARD = smi[0].strip()
    print(CARD, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}; TF32 off", flush=True)


def phase_build(modules) -> None:
    phase("build (one nvcc per source, in parallel)")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        builds = list(pool.map(lambda m: m.load(), modules))
    report(f"{len(builds)} kernel libraries ready in {time.perf_counter() - t0:.2f} s")
    for built in builds:
        report(f"built {built.path.name} for sm_90a in {built.seconds:.2f} s "
               f"(0 = reused an earlier build)")
        for line in built.ptxas.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print("  ptxas:", line.strip().removeprefix("ptxas info    : "), flush=True)


def phase_kernel(torch, sm, dev) -> tuple[dict, dict]:
    """The bf16/f32 kernel and its l2 mode against their plain versions."""
    phase("kernel against its plain version: subtile_max, and its l2 mode")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    for dt_name, b in KERNEL_CASES:
        dtype = torch.bfloat16 if dt_name == "bf16" else torch.float32
        x = unit_rows(gen, KERNEL_N, DIM, dtype, dev)
        valid = torch.rand(KERNEL_N, generator=gen, device=dev) > 0.03
        x[~valid] = 0
        q = unit_rows(gen, b, DIM, dtype, dev)
        got = sm.subtile_max(q, x, valid, G)
        torch.cuda.synchronize()
        want = sm.subtile_max_plain(q, x, valid, G)
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        report(f"{dt_name} B={b} N={KERNEL_N} d={DIM} g={G}: max|kernel - plain| = "
               f"{err:.3e} (atol {TOL:g}), dead rows {int((~valid).sum())}")
        check(got.shape == (b, KERNEL_N // G), f"kernel output shape {tuple(got.shape)}")
        check(err <= TOL, f"kernel disagrees with its plain version: {err} > {TOL}")

    l2_err = 0.0
    for dt_name, b in L2_CASES:
        dtype = torch.bfloat16 if dt_name == "bf16" else torch.float32
        x = unit_rows(gen, KERNEL_N, DIM, dtype, dev)
        valid = torch.rand(KERNEL_N, generator=gen, device=dev) > 0.03
        x[~valid] = 0
        sq = (x.float() * x.float()).sum(1)
        q = unit_rows(gen, b, DIM, dtype, dev)
        got = sm.subtile_max(q, x, valid, G, sqnorm=sq)
        torch.cuda.synchronize()
        err = float((got - sm.subtile_max_plain(q, x, valid, G, sqnorm=sq)).abs().max())
        l2_err = max(l2_err, err)
        report(f"l2 {dt_name} B={b} N={KERNEL_N} d={DIM} g={G}: max|kernel - plain| = "
               f"{err:.3e} (atol {TOL:g})")
        check(err <= TOL, f"l2 kernel disagrees with its plain version: {err} > {TOL}")
    del x, valid, q, sq, got

    x = unit_rows(gen, TIMING_N, DIM, torch.bfloat16, dev)
    valid = torch.rand(TIMING_N, generator=gen, device=dev) > 0.03
    x[~valid] = 0
    n = TIMING_N - TIMING_N % G
    x, valid = x[:n].contiguous(), valid[:n].contiguous()
    q = unit_rows(gen, BATCH, DIM, torch.bfloat16, dev)
    flops = 2.0 * BATCH * n * DIM
    kernel = lambda: sm.subtile_max(q, x, valid, G)  # noqa: E731
    plain = lambda: sm.subtile_max_plain(q, x, valid, G)  # noqa: E731
    got, want = kernel(), plain()  # also warms both up
    err = float((got - want).abs().max())
    max_err = max(max_err, err)
    report(f"bf16 B={BATCH} N={n} d={DIM} g={G}: max|kernel - plain| = {err:.3e} "
           f"(atol {TOL:g}), dead rows {int((~valid).sum())}")
    check(err <= TOL, f"kernel disagrees with its plain version at N={n}: {err} > {TOL}")
    del got, want
    ip = in_turns(kernel, plain, f"bf16 B={BATCH} N={n} d={DIM} g={G}", flops,
                  "TFLOP/s", n * DIM * 2)

    sq = (x.float() * x.float()).sum(1)
    kernel = lambda: sm.subtile_max(q, x, valid, G, sqnorm=sq)  # noqa: E731
    plain = lambda: sm.subtile_max_plain(q, x, valid, G, sqnorm=sq)  # noqa: E731
    got, want = kernel(), plain()
    err = float((got - want).abs().max())
    l2_err = max(l2_err, err)
    report(f"l2 bf16 B={BATCH} N={n} d={DIM} g={G}: max|kernel - plain| = {err:.3e} "
           f"(atol {TOL:g})")
    check(err <= TOL, f"l2 kernel disagrees with its plain version at N={n}: {err} > {TOL}")
    del got, want
    l2 = in_turns(kernel, plain, f"l2 bf16 B={BATCH} N={n} d={DIM} g={G}", flops,
                  "TFLOP/s", n * DIM * 2)
    del x, valid, q, sq
    torch.cuda.empty_cache()
    nbytes = n * DIM * 2 + n + BATCH * DIM * 2 + 4 * BATCH * (n // G)
    return ({"max_abs_err": max_err, **ip, **bound(flops, H100_BF16_PEAK, nbytes),
             "library_ms": None},
            {"max_abs_err": l2_err, **l2,
             **bound(flops, H100_BF16_PEAK, nbytes + 4 * n + 4 * BATCH), "library_ms": None})


def i8_inputs(torch, gen, n, b, block, dev):
    """Random int8 codes with positive scales (one per 32-row block, or
    one per row), ~3% dead rows zeroed, and random int8 query codes."""
    codes = torch.randint(-127, 128, (n, DIM), generator=gen, device=dev, dtype=torch.int8)
    if block:
        scale = torch.rand(n // 32, generator=gen, device=dev).repeat_interleave(32)
    else:
        scale = torch.rand(n, generator=gen, device=dev)
    scale = (scale + 0.1) * 1e-2
    valid = torch.rand(n, generator=gen, device=dev) > 0.03
    codes[~valid] = 0
    q = torch.randint(-127, 128, (b, DIM), generator=gen, device=dev, dtype=torch.int8)
    return q, codes, scale, valid


def phase_kernel_i8(torch, smi8, dev) -> dict:
    phase("kernel against its plain version: subtile_max_i8 (exact)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    max_err = 0.0
    for block, b in I8_CASES:
        q, codes, scale, valid = i8_inputs(torch, gen, KERNEL_N, b, block, dev)
        got = smi8.subtile_max_i8(q, codes, scale, valid, G, block_scales=block)
        torch.cuda.synchronize()
        want = smi8.subtile_max_i8_plain(q, codes, scale, valid, G, block_scales=block)
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        report(f"int8 {'block' if block else 'per-row'} scales B={b} N={KERNEL_N} d={DIM} "
               f"g={G}: max|kernel - plain| = {err:.3e} (must be 0), dead rows "
               f"{int((~valid).sum())}")
        check(got.shape == (b, KERNEL_N // G), f"int8 kernel output shape {tuple(got.shape)}")
        check(err == 0.0, f"int8 kernel differs from its plain version: {err}")
    del q, codes, scale, valid, got, want

    n = TIMING_N - TIMING_N % G
    q, codes, scale, valid = i8_inputs(torch, gen, n, BATCH, True, dev)
    kernel = lambda: smi8.subtile_max_i8(q, codes, scale, valid, G)  # noqa: E731
    plain = lambda: smi8.subtile_max_i8_plain(q, codes, scale, valid, G)  # noqa: E731
    got, want = kernel(), plain()
    err = float((got - want).abs().max())
    max_err = max(max_err, err)
    report(f"int8 block scales B={BATCH} N={n} d={DIM} g={G}: max|kernel - plain| = "
           f"{err:.3e} (must be 0)")
    check(err == 0.0, f"int8 kernel differs from its plain version at N={n}: {err}")
    del got, want
    timed = in_turns(kernel, plain, f"int8 block scales B={BATCH} N={n} d={DIM} g={G}",
                     2.0 * BATCH * n * DIM, "TOP/s", n * DIM)

    scale = (torch.rand(n, generator=gen, device=dev) + 0.1) * 1e-2  # per-row scales
    kernel = lambda: smi8.subtile_max_i8(q, codes, scale, valid, G, block_scales=False)  # noqa: E731
    plain = lambda: smi8.subtile_max_i8_plain(q, codes, scale, valid, G, block_scales=False)  # noqa: E731
    got, want = kernel(), plain()
    err = float((got - want).abs().max())
    max_err = max(max_err, err)
    report(f"int8 per-row scales B={BATCH} N={n} d={DIM} g={G}: max|kernel - plain| = "
           f"{err:.3e} (must be 0)")
    check(err == 0.0, f"int8 per-row kernel differs from its plain version at N={n}: {err}")
    del got, want
    per_row = in_turns(kernel, plain, f"int8 per-row scales B={BATCH} N={n} d={DIM} g={G}",
                       2.0 * BATCH * n * DIM, "TOP/s", n * DIM)
    del q, codes, scale, valid
    torch.cuda.empty_cache()
    nbytes = n * DIM + n + 4 * n + BATCH * DIM + 4 * BATCH * (n // G)
    return {"max_abs_err": max_err, **timed,
            **bound(2.0 * BATCH * n * DIM, H100_INT8_PEAK, nbytes), "library_ms": None,
            "per_row_ms": per_row["ms"], "per_row_plain_ms": per_row["plain_ms"]}


def phase_kernel_piped(torch, sm, smi8, smp, dev) -> dict:
    """The pipelined producer against its plain version, then in turns
    against the stream kernels it would replace."""
    phase("kernel against its plain version: subtile_max_piped (bf16/f32, int8 exact)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    max_err = 0.0
    for dt_name, b in PIPED_CASES:
        if dt_name == "int8":
            q, x, scale, valid = i8_inputs(torch, gen, KERNEL_N, b, True, dev)
        else:
            dtype = torch.bfloat16 if dt_name == "bf16" else torch.float32
            x = unit_rows(gen, KERNEL_N, DIM, dtype, dev)
            valid = torch.rand(KERNEL_N, generator=gen, device=dev) > 0.03
            x[~valid] = 0
            q, scale = unit_rows(gen, b, DIM, dtype, dev), None
        got = smp.subtile_max_piped(q, x, valid, G, scale=scale)
        torch.cuda.synchronize()
        want = smp.subtile_max_piped_plain(q, x, valid, G, scale=scale)
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        bar = 0.0 if dt_name == "int8" else TOL
        report(f"piped {dt_name} B={b} N={KERNEL_N} d={DIM} g={G}: max|kernel - plain| = "
               f"{err:.3e} (bound {bar:g}), dead rows {int((~valid).sum())}")
        check(got.shape == (b, KERNEL_N // G), f"piped output shape {tuple(got.shape)}")
        check(err <= bar, f"subtile_max_piped disagrees with its plain version: {err}")
    del q, x, valid, got, want

    n = TIMING_N - TIMING_N % G
    x = unit_rows(gen, n, DIM, torch.bfloat16, dev)
    valid = torch.rand(n, generator=gen, device=dev) > 0.03
    x[~valid] = 0
    q = unit_rows(gen, BATCH, DIM, torch.bfloat16, dev)
    kernel = lambda: smp.subtile_max_piped(q, x, valid, G)  # noqa: E731
    plain = lambda: smp.subtile_max_piped_plain(q, x, valid, G)  # noqa: E731
    stream = lambda: sm.subtile_max(q, x, valid, G)  # noqa: E731
    got, want = kernel(), plain()
    err = float((got - want).abs().max())
    max_err = max(max_err, err)
    same = bool(torch.equal(got, stream()))
    report(f"piped bf16 B={BATCH} N={n}: max|kernel - plain| = {err:.3e} (atol {TOL:g}); "
           f"equal to subtile_max.cu's output: {same}")
    check(err <= TOL, f"subtile_max_piped disagrees with its plain version at N={n}: {err}")
    del got, want
    flops = 2.0 * BATCH * n * DIM
    timed = in_turns(kernel, plain, f"piped bf16 B={BATCH} N={n} d={DIM} g={G}", flops,
                     "TFLOP/s", n * DIM * 2)
    s1, p1, p2, s2 = (cuda_ms(f, 10) for f in (stream, kernel, kernel, stream))
    report(f"piped against subtile_max.cu, bf16 B={BATCH} N={n}, in turns (stream, piped, "
           f"piped, stream): piped {p1:.3f} / {p2:.3f} ms, stream {s1:.3f} / {s2:.3f} ms")
    nbytes = n * DIM * 2 + n + BATCH * DIM * 2 + 4 * BATCH * (n // G)
    out = {"max_abs_err": max_err, **timed, **bound(flops, H100_BF16_PEAK, nbytes),
           "library_ms": None, "stream_ms": (s1 + s2) / 2}
    del x, valid, q

    q, codes, scale, valid = i8_inputs(torch, gen, n, BATCH, True, dev)
    piped = lambda: smp.subtile_max_piped(q, codes, valid, G, scale=scale)  # noqa: E731
    stream = lambda: smi8.subtile_max_i8(q, codes, scale, valid, G)  # noqa: E731
    same = bool(torch.equal(piped(), stream()))
    s1, p1, p2, s2 = (cuda_ms(f, 10) for f in (stream, piped, piped, stream))
    report(f"piped int8 B={BATCH} N={n}: equal to subtile_max_i8.cu's output: {same}; in "
           f"turns: piped {p1:.3f} / {p2:.3f} ms, subtile_max_i8 {s1:.3f} / {s2:.3f} ms")
    check(same, "piped int8 differs from subtile_max_i8 at N=2M")
    out["i8_ms"], out["i8_stream_ms"] = (p1 + p2) / 2, (s1 + s2) / 2
    del q, codes, scale, valid
    torch.cuda.empty_cache()
    return out


def probe_corpus(torch, gen, n, dev):
    """The probe's recipe: N(0, 1) unit rows (bf16), 3% dead and zeroed,
    queries that are corpus rows plus 0.1 noise."""
    x = torch.randn((n, DIM), generator=gen, device=dev)
    x /= torch.linalg.norm(x, dim=1, keepdim=True)
    valid = torch.rand(n, generator=gen, device=dev) > 0.03
    x[~valid] = 0
    return x.to(torch.bfloat16), valid


def probe_queries(torch, gen, x, b, dev):
    idx = torch.randint(0, x.shape[0], (b,), generator=gen, device=dev)
    q = x[idx].float() + 0.1 * torch.randn((b, DIM), generator=gen, device=dev)
    return q / torch.linalg.norm(q, dim=1, keepdim=True)


def compare_topk(torch, fm, got, want, packed: bool, what: str) -> float:
    """Checks the fused kernel's (scores, ids) against its plain version's:
    not packed, scores within TOL and ids equal except between candidates
    within TOL of the k-th score; packed, quantized scores equal or one
    quantum apart, and ids equal except within one quantum of the k-th.
    Returns the max abs score difference."""
    gs, gp = (t.cpu() for t in got)
    ws, wp = (t.cpu() for t in want)
    err = float((gs - ws).abs().max())
    if packed:  # scores in quanta: the key with its index bits shifted out
        bits = fm.packed_bits(FUSED_TILE, True)
        gv = (fm.quantize_keys(gs, bits).long() >> bits).double()
        wv = (fm.quantize_keys(ws, bits).long() >> bits).double()
        slack = 1.0
    else:
        gv, wv, slack = gs.double(), ws.double(), TOL
    off = float((gv - wv).abs().max())
    bad = 0
    for i in range(gp.shape[0]):
        diff = set(gp[i].tolist()) ^ set(wp[i].tolist())
        score = dict(zip(gp[i].tolist() + wp[i].tolist(), gv[i].tolist() + wv[i].tolist()))
        bad += any(abs(score[p] - float(wv[i, -1])) > slack for p in diff)
    report(f"fused {what}: max|kernel - plain| score {err:.3e}, "
           f"{'quanta' if packed else 'abs'} apart at most {off:g} (bound {slack:g}); rows "
           f"whose ids differ beyond a tie at the k-th score: {bad}")
    check(off <= slack, f"fused_mips_topk scores disagree with its plain version ({what})")
    check(bad == 0, f"fused_mips_topk ids disagree with its plain version ({what})")
    return err


def phase_kernel_fused(torch, fm, dev) -> dict:
    phase("kernel against its plain version: fused_mips_topk (cosine, bf16, tile 2048)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    x, valid = probe_corpus(torch, gen, KERNEL_N, dev)
    sq = torch.ones(KERNEL_N, device=dev)
    max_err = 0.0
    for b, skip, packed in FUSED_CASES:
        q = probe_queries(torch, gen, x, b, dev)
        got = fm.fused_mips_topk(q, x, valid, sq, K, tile_n=FUSED_TILE, skip_tiles=skip,
                                 packed=packed)
        torch.cuda.synchronize()
        want = fm.fused_mips_topk_plain(q, x, valid, sq, K, FUSED_TILE, "cosine", skip, packed)
        check(got[0].shape == (b, K) and got[1].shape == (b, K), "fused output shape")
        max_err = max(max_err, compare_topk(
            torch, fm, got, want, packed,
            f"B={b} N={KERNEL_N} skip_tiles={skip} packed={packed}"))
    del x, valid, sq

    n = -(-PROBE_N // 4096) * 4096  # the probe pads its rows to 4096
    x, valid = probe_corpus(torch, gen, n, dev)
    valid[PROBE_N:] = False
    x[PROBE_N:] = 0
    sq = torch.ones(n, device=dev)
    q = probe_queries(torch, gen, x[:PROBE_N], BATCH, dev)
    kernel = lambda: fm.fused_mips_topk(q, x, valid, sq, K, tile_n=FUSED_TILE,  # noqa: E731
                                        skip_tiles=True, packed=True)
    plain = lambda: fm.fused_mips_topk_plain(q, x, valid, sq, K, FUSED_TILE,  # noqa: E731
                                             "cosine", True, True)
    max_err = max(max_err, compare_topk(torch, fm, kernel(), plain(), True,
                                        f"B={BATCH} N={n} skip_tiles packed"))
    flops = 2.0 * BATCH * n * DIM
    timed = in_turns(kernel, plain, f"fused bf16 B={BATCH} N={n} d={DIM} k={K} skip_tiles "
                     "packed", flops, "TFLOP/s", n * DIM * 2)
    unpacked = lambda: fm.fused_mips_topk(q, x, valid, sq, K, tile_n=FUSED_TILE)  # noqa: E731
    unpacked()
    report(f"fused, skip_tiles and packed off: {cuda_ms(unpacked, 5):.3f} ms (CUDA events)")
    nbytes = n * DIM * 2 + n + BATCH * DIM * 2 + 8 * BATCH * K
    del x, valid, sq, q
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, **timed, **bound(flops, H100_BF16_PEAK, nbytes),
            "library_ms": None}


def phase_kernel_stream(torch, cst, dev) -> dict:
    phase("kernel against its plain version: corpus_stream (exact)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        if dtype == torch.int8:
            x = torch.randint(-127, 128, (KERNEL_N, DIM), generator=gen, device=dev,
                              dtype=torch.int8)
        else:
            x = torch.randn((KERNEL_N, DIM), generator=gen, device=dev).to(dtype)
        got = cst.corpus_stream(x)
        torch.cuda.synchronize()
        err = float((got - cst.corpus_stream_plain(x)).abs().max())
        report(f"corpus_stream {dtype} N={KERNEL_N} d={DIM}: max|kernel - plain| = {err:.3e} "
               f"(must be 0)")
        check(got.shape == (8, DIM) and err == 0.0, f"corpus_stream differs: {err}")
    n = TIMING_N
    x = torch.randn((n, DIM), generator=gen, device=dev).to(torch.bfloat16)
    kernel = lambda: cst.corpus_stream(x)  # noqa: E731
    plain = lambda: cst.corpus_stream_plain(x)  # noqa: E731
    lib = lambda: torch.amax(x.view(-1, 8, DIM), dim=0)  # noqa: E731
    err = float((kernel() - plain()).abs().max())
    check(err == 0.0 and torch.equal(kernel(), lib().float()),
          "corpus_stream differs from its plain version or the library call at N=2M")
    nbytes = n * DIM * 2 + 8 * DIM * 4
    timed = in_turns(kernel, plain, f"corpus_stream bf16 N={n} d={DIM}", n * DIM,
                     "T max/s", nbytes, "of corpus")
    lib_ms = library_ms(lib, f"torch.amax(corpus.view(-1, 8, {DIM}), dim=0) bf16 N={n}")
    del x
    torch.cuda.empty_cache()
    return {"max_abs_err": err, **timed, **bound(n * DIM, H100_F32_PEAK, nbytes),
            "library_ms": lib_ms}


def phase_probe(torch, smp, fm, cst, dev) -> dict:
    """The kernel probe, the path of the last three kernels: its default
    sweep plus every producer, both fused modes and both corpus types."""
    from rag_arc_tpu_torch.tools import kernel_probe as kp

    configs = kp.parse_configs("") + PROBE_CONFIGS
    phase(f"kernel probe: {PROBE_N} x {DIM} bf16 (+ int8), B={BATCH}, k={K}, "
          f"{len(configs)} configs, {PROBE_REPS} streams of {PROBE_STREAM} batches")
    t0 = time.perf_counter()
    data = kp.make_data(PROBE_N, DIM, BATCH, PROBE_STREAM, K, SEED, dev, int8=True)
    torch.cuda.synchronize()
    report(f"probe data made on the card in {time.perf_counter() - t0:.1f} s")
    counters = {"subtile_max_piped": Counter(smp), "fused_mips_topk": Counter(fm),
                "corpus_stream": Counter(cst)}
    for c in counters.values():
        c.reset()
    stream_top = {}
    for cfg in configs:
        try:
            line, top = kp.probe(cfg, data, K, PROBE_REPS, dev)
        except Exception as exc:  # noqa: BLE001 — reported, then the run fails
            raise SmokeFailure(f"probe config {cfg} failed: {exc}") from exc
        report("probe " + json.dumps(line))
        if line["recall"] is not None:
            check(line["recall"] >= 0.99, f"probe {cfg}: recall@10 {line['recall']} < 0.99")
        if cfg["kind"] == "stream":
            stream_top[cfg["producer"]] = top
    launches = {name: c.read() for name, c in counters.items()}
    # the two kernels give bit-equal sub-tile maxima, so equal ids; the
    # scan's f32 matmul sums in another order, so its ids may differ from
    # theirs only between candidates tied with the k-th score
    (s_ref, ids_ref), (_, ids_piped) = stream_top["stream"], stream_top["stream_piped"]
    same = bool(np.array_equal(ids_ref, ids_piped))
    s_scan, ids_scan = stream_top["scan"]
    rows = np.flatnonzero((ids_scan != ids_ref).any(axis=1))
    untied = 0
    for i in rows:
        score = dict(zip(ids_ref[i].tolist() + ids_scan[i].tolist(),
                         s_ref[i].tolist() + s_scan[i].tolist()))
        diff = set(ids_ref[i].tolist()) ^ set(ids_scan[i].tolist())
        untied += any(abs(score[p] - float(s_ref[i, -1])) > TOL for p in diff)
    # pass 1 itself, on the same batch: the scan's maxima against
    # subtile_max.cu's, so the relaxed id check rests on a direct one
    cfg = PROBE_CONFIGS[0]
    q0 = data["batches"][0].to(data["emb"].dtype)
    p1 = {p: kp.produce(p, q0, data["emb"], data["valid"], cfg["g"], cfg["tile_n"])
          for p in ("stream", "scan")}
    gaps = (p1["scan"] - p1["stream"]).abs()
    gap = float(gaps.max())
    gap_rows = float(gaps[torch.as_tensor(rows, device=dev)].max()) if len(rows) else 0.0
    del p1, gaps
    report(f"probe: stream and stream_piped ids equal: {same}; scan ids differ in "
           f"{len(rows)} of {len(ids_ref)} rows, beyond a tie at the k-th score (atol "
           f"{TOL:g}) in {untied}; pass 1 on that batch, max|scan - subtile_max.cu| = "
           f"{gap:.3e} (atol {TOL:g}), {gap_rows:.3e} on the rows whose ids differ; "
           f"kernel launches {launches}")
    check(same, "the stream and stream_piped producers' ids differ")
    check(untied == 0, "the scan producer's ids differ beyond ties at the k-th score")
    check(gap <= TOL, f"the scan's pass-1 maxima disagree with subtile_max.cu's: {gap}")
    for name, n in launches.items():
        check(n >= 1, f"the probe never launched {name}")
    del data
    torch.cuda.empty_cache()
    return launches


def make_index_data(torch, dev) -> dict:
    """The shared corpus (host f32, unit rows), query batches and the f32
    exact cosine oracle of the first ORACLE_QUERIES queries."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    corpus = rng.random((CORPUS_N, DIM), dtype=np.float32)
    corpus -= 0.5
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    q_idx = rng.integers(0, CORPUS_N, size=BATCH * N_BATCHES)
    queries = corpus[q_idx] + 0.1 * rng.standard_normal((BATCH * N_BATCHES, DIM), dtype=np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    gen_s = time.perf_counter() - t0
    sub_q = torch.from_numpy(queries[:ORACLE_QUERIES]).to(dev)
    scores = torch.empty((ORACLE_QUERIES, CORPUS_N), device=dev)
    chunk = 1 << 18
    for start in range(0, CORPUS_N, chunk):  # f32, TF32 off: the exact oracle
        part = torch.from_numpy(corpus[start : start + chunk]).to(dev)
        scores[:, start : start + chunk] = sub_q @ part.T
    exact = torch.topk(scores, K, dim=1).indices.cpu().numpy()
    del scores
    torch.cuda.empty_cache()
    batches = [torch.from_numpy(queries[i * BATCH : (i + 1) * BATCH]).to(dev)
               for i in range(N_BATCHES)]
    return {"corpus": corpus, "queries": queries, "batches": batches, "exact": exact,
            "gen_s": gen_s}


def recall_at_k(got: np.ndarray, exact: np.ndarray) -> float:
    return float(np.mean([len(set(got[i]) & set(exact[i])) / K for i in range(len(exact))]))


def run_batches(index, batches, counter):
    """Search every batch (dispatch all, then fetch all), then time 10
    single batches; returns (fetched, QPS, p50 ms, kernel launches)."""
    from rag_arc_tpu_torch.index.flat import fetch_pair

    fetch_pair(*index.search_device(batches[0], K))  # warm up
    counter.reset()
    t0 = time.perf_counter()
    outs = [index.search_device(b, K) for b in batches]
    fetched = [fetch_pair(s, p) for s, p in outs]
    sustained_s = time.perf_counter() - t0
    launches = counter.read()
    qps = BATCH * len(batches) / sustained_s
    times = []
    for b in batches[:10]:
        t1 = time.perf_counter()
        fetch_pair(*index.search_device(b, K))
        times.append(time.perf_counter() - t1)
    p50 = float(np.percentile(times, 50)) * 1e3
    report(f"sustained {qps:.1f} QPS ({len(batches)} x {BATCH} queries in "
           f"{sustained_s:.3f} s, dispatch all then fetch all); p50 batch "
           f"{p50:.3f} ms incl. readback; kernel launches {launches}")
    check(launches >= len(batches),
          f"kernel launched {launches} times for {len(batches)} searches")
    return fetched, qps, p50, launches


class Counter:
    """Reads and resets one wrapper's launch count."""

    def __init__(self, module, name: str = "launches"):
        self.module, self.name = module, name

    def reset(self) -> None:
        setattr(self.module, self.name, 0)

    def read(self) -> int:
        return getattr(self.module, self.name)


def phase_index(torch, sm, dev, data) -> None:
    from rag_arc_tpu_torch.index.flat import DeviceFlatIndex
    from rag_arc_tpu_torch.ops.two_level import prepare_queries, select_rescore

    phase(f"index: {CORPUS_N} x {DIM} bf16, {N_BATCHES} batches of {BATCH}, k={K}")
    corpus, batches = data["corpus"], data["batches"]
    t0 = time.perf_counter()
    index = DeviceFlatIndex(dim=DIM, metric="cosine", capacity=CORPUS_N,
                            dtype=torch.bfloat16, device=dev)
    step = 1 << 17
    for start in range(0, CORPUS_N, step):
        index.add(corpus[start : start + step])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    report(f"host data {data['gen_s']:.1f} s; index build {build_s:.1f} s; capacity "
           f"{index.capacity}, {index.stats()['hbm_bytes'] / 2**30:.2f} GiB on the card")
    check(4 * BATCH * index.capacity > index.SCORE_BYTES_BUDGET,
          "index search would not take the kernel path")
    fetched, _, _, _ = run_batches(index, batches, Counter(sm))

    for i in range(2):
        qc = prepare_queries(batches[i], index.dtype, "cosine")
        sub = sm.subtile_max_plain(qc, index.emb, index.valid, G)
        _, p_plain = select_rescore(qc, index.emb, index.valid, sub, K, G)
        same = np.array_equal(p_plain.cpu().numpy(), fetched[i][1])
        report(f"batch {i}: ids equal to the plain producer's: {same}")
        check(same, f"batch {i}: kernel-path ids differ from the plain producer's")
    del sub, p_plain

    got = fetched[0][1][:ORACLE_QUERIES]  # batch 0's first rows are the oracle queries
    recall = recall_at_k(got, data["exact"])
    report(f"recall@10 vs f32 exact on {ORACLE_QUERIES} queries: {recall:.4f} (bar 0.99)")
    check(recall >= 0.99, f"recall@10 {recall} < 0.99")
    del index
    torch.cuda.empty_cache()


def phase_index_l2(torch, sm, dev, data) -> int:
    from rag_arc_tpu_torch.index.flat import DeviceFlatIndex
    from rag_arc_tpu_torch.ops.two_level import prepare_queries, select_rescore

    phase(f"index: {L2_N} x {DIM} bf16 l2, {L2_BATCHES} batches of {BATCH}, k={K}")
    corpus = data["corpus"][:L2_N]
    batches = data["batches"][:L2_BATCHES]
    index = DeviceFlatIndex(dim=DIM, metric="l2", capacity=L2_N, dtype=torch.bfloat16,
                            device=dev)
    for start in range(0, L2_N, 1 << 17):
        index.add(corpus[start : start + (1 << 17)])
    check(4 * BATCH * index.capacity > index.SCORE_BYTES_BUDGET,
          "l2 search would not take the kernel path")
    fetched, _, _, launches = run_batches(index, batches, Counter(sm, "launches_l2"))

    qc = prepare_queries(batches[0], index.dtype, "l2")
    sub = sm.subtile_max_plain(qc, index.emb, index.valid, G, sqnorm=index.sqnorm)
    _, p_plain = select_rescore(qc, index.emb, index.valid, sub, K, G, "l2", index.sqnorm)
    same = np.array_equal(p_plain.cpu().numpy(), fetched[0][1])
    report(f"batch 0: ids equal to the plain producer's: {same}")
    check(same, "l2 kernel-path ids differ from the plain producer's")
    del sub, p_plain

    q = batches[0][:ORACLE_QUERIES]
    q_sq = (q * q).sum(1, keepdim=True)
    scores = torch.empty((ORACLE_QUERIES, L2_N), device=dev)
    for start in range(0, L2_N, 1 << 18):  # f32, TF32 off: the exact l2 oracle
        part = torch.from_numpy(corpus[start : start + (1 << 18)]).to(dev)
        scores[:, start : start + (1 << 18)] = -(q_sq - 2.0 * (q @ part.T)
                                                 + (part * part).sum(1)[None, :])
    exact = torch.topk(scores, K, dim=1).indices.cpu().numpy()
    recall = recall_at_k(fetched[0][1][:ORACLE_QUERIES], exact)
    report(f"l2 recall@10 vs f32 exact on {ORACLE_QUERIES} queries: {recall:.4f} (bar 0.99)")
    check(recall >= 0.99, f"l2 recall@10 {recall} < 0.99")
    del index, scores
    torch.cuda.empty_cache()
    return launches


def resident_bytes(index) -> int:
    return sum(t.numel() * t.element_size() for t in index._arrays())


def phase_index_i8(torch, smi8, dev, data) -> None:
    from rag_arc_tpu_torch.index.flat import DeviceFlatIndex, fetch_pair
    from rag_arc_tpu_torch.index.vector_store import get_tracer
    from rag_arc_tpu_torch.ops.two_level import quantize_queries, select_rescore_i8

    phase(f"index: {CORPUS_N} x {DIM} int8 + int4 refine, kf_mult 2, "
          f"{N_BATCHES} batches of {BATCH}, k={K}")
    corpus, batches = data["corpus"], data["batches"]
    get_tracer().reset()
    t0 = time.perf_counter()
    index = DeviceFlatIndex(dim=DIM, metric="cosine", capacity=CORPUS_N,
                            dtype=torch.int8, device=dev)
    for start in range(0, CORPUS_N, 1 << 17):
        index.add(corpus[start : start + (1 << 17)])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    quant_s = get_tracer().summary()["index.quantize"]["total_ms"] / 1e3
    resident = resident_bytes(index)
    report(f"index build {build_s:.1f} s, of it host quantization + residual "
           f"encoding {quant_s:.1f} s (host clock); refine {index.refine}, kf_mult "
           f"{index.kf_mult}, gap rows {index._gap_rows}; {resident / 2**30:.3f} GiB "
           f"resident on the card (stats hbm_bytes {index.stats()['hbm_bytes']})")
    fetched, qps, p50, _ = run_batches(index, batches, Counter(smi8))

    kf = index._kf(K)
    for i in range(2):
        q_i8, qscale = quantize_queries(batches[i])
        sub = smi8.subtile_max_i8_plain(q_i8, index.emb, index.sqnorm, index.valid, G)
        s, p = select_rescore_i8(q_i8, qscale, index.emb, index.sqnorm, index.valid,
                                 sub, kf, G)
        _, p_plain = fetch_pair(*index.rescore_candidates(batches[i], s, p, K))
        same = np.array_equal(p_plain, fetched[i][1])
        report(f"batch {i}: ids equal to the plain producer's: {same}")
        check(same, f"int8 batch {i}: kernel-path ids differ from the plain producer's")
    del sub, s, p

    recall = recall_at_k(fetched[0][1][:ORACLE_QUERIES], data["exact"])
    report(f"int8 recall@10 vs f32 exact on {ORACLE_QUERIES} queries: {recall:.4f} "
           f"(bar 0.99); {qps:.1f} QPS, p50 {p50:.3f} ms")
    check(recall >= 0.99, f"int8 recall@10 {recall} < 0.99")

    q = batches[0]
    q_i8, qscale = quantize_queries(q)
    sub = smi8.subtile_max_i8(q_i8, index.emb, index.sqnorm, index.valid, G)
    s, p = select_rescore_i8(q_i8, qscale, index.emb, index.sqnorm, index.valid, sub, kf, G)
    layers = {
        "search": lambda: index.search_device(q, K),
        "query quantization": lambda: quantize_queries(q),
        "kernel": lambda: smi8.subtile_max_i8(q_i8, index.emb, index.sqnorm, index.valid, G),
        "select + int8 rescore": lambda: select_rescore_i8(
            q_i8, qscale, index.emb, index.sqnorm, index.valid, sub, kf, G),
        "refined rescore": lambda: index.rescore_candidates(q, s, p, K),
    }
    report(f"int8 layers, one batch B={BATCH} (CUDA events): " + ", ".join(
        f"{name} {cuda_ms(fn, 5):.3f} ms" for name, fn in layers.items()))
    del sub, s, p

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = smi8.launches
    one = torch.from_numpy(data["queries"][:1]).to(dev)
    fetch_pair(*index.search_device(one, K))
    peak = torch.cuda.max_memory_allocated()
    report(f"B=1 search: peak {peak / 2**30:.3f} GiB allocated against "
           f"{resident / 2**30:.3f} GiB resident (+{(peak - base) / 2**20:.1f} MiB over "
           f"what was allocated before it); took the kernel path: "
           f"{smi8.launches == before + 1}")
    check(smi8.launches == before + 1, "B=1 int8 search did not launch the kernel")
    check(peak <= resident + 2**30, "B=1 int8 search peaked above resident + 1 GiB")
    del index
    torch.cuda.empty_cache()


def make_docs(rng) -> list[str]:
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    wl = rng.integers(3, 11, DOC_VOCAB)
    chars = letters[rng.integers(0, 26, int(wl.sum()))]
    ends = np.cumsum(wl)
    vocab = np.array(["".join(chars[e - n : e]) for n, e in zip(wl, ends)], dtype=object)
    lens = rng.integers(8, 49, N_DOCS)
    words = vocab[rng.integers(0, DOC_VOCAB, int(lens.sum()))]
    ends = np.cumsum(lens)
    return [" ".join(words[e - n : e]) for n, e in zip(lens, ends)]


def layer_times(torch, sm, store, emb, batch_texts) -> None:
    """Device time of each layer of one B=512 query batch (CUDA events)."""
    from rag_arc_tpu_torch.ops.two_level import prepare_queries, select_rescore

    t0 = time.perf_counter()
    ids, mask = emb.tokenizer.batch_encode(batch_texts)
    length = emb._bucket_len(ids.shape[1])
    ids = np.pad(ids, ((0, 0), (0, length - ids.shape[1])))
    mask = np.pad(mask, ((0, 0), (0, length - mask.shape[1])))
    tok_ms = (time.perf_counter() - t0) * 1e3
    dev = store.device
    ids_d, mask_d = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
    q = emb.encode_device(ids_d, mask_d)
    index = store.index
    qc = prepare_queries(q, index.dtype, "cosine")
    sub = sm.subtile_max(qc, index.emb, index.valid, G)
    enc = cuda_ms(lambda: emb.encode_device(ids_d, mask_d), 5)
    search = cuda_ms(lambda: index.search_device(q, K), 5)
    kern = cuda_ms(lambda: sm.subtile_max(qc, index.emb, index.valid, G), 5)
    sel = cuda_ms(lambda: select_rescore(qc, index.emb, index.valid, sub, K, G), 5)
    report(f"layers, one batch B={BATCH} L={length}: tokenize {tok_ms:.2f} ms (host), "
           f"encoder {enc:.3f} ms, search {search:.3f} ms = sub-tile-max kernel "
           f"{kern:.3f} ms + select/rescore {sel:.3f} ms + query prep (CUDA events)")


def phase_end_to_end(torch, sm, dev):
    from rag_arc_tpu_torch.index.vector_store import Document, TorchVectorStore, get_tracer
    from rag_arc_tpu_torch.models.encoder import TransformerConfig
    from rag_arc_tpu_torch.models.torch_embeddings import TorchEncoderEmbeddings

    cfg = TransformerConfig()
    phase(f"end to end: encoder {cfg.dim}x{cfg.depth} bf16 (seeded random "
          f"weights), {N_DOCS} documents, capacity {STORE_CAPACITY}")
    rng = np.random.default_rng(SEED)
    texts = make_docs(rng)
    ids = [f"d{i}" for i in range(N_DOCS)]
    emb = TorchEncoderEmbeddings(cfg, seed=SEED, device=dev)

    sm.launches = 0
    t0 = time.perf_counter()
    store = TorchVectorStore.from_texts(
        texts, emb, ids=ids, capacity=STORE_CAPACITY, dtype=torch.bfloat16, device=dev
    )
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    report(f"ingest {N_DOCS} docs in {ingest_s:.1f} s = {N_DOCS / ingest_s:.1f} docs/s "
           f"(tokenize + pack + encode + index add)")
    check(len(store) == N_DOCS, f"store holds {len(store)} documents")

    picks = rng.choice(N_DOCS, size=E2E_BATCHES * BATCH, replace=False)
    store.batch_similarity_search_with_score([texts[i] for i in picks[:BATCH]], k=K)  # warm
    get_tracer().reset()
    hits_top10 = hits_top1 = 0
    t0 = time.perf_counter()
    results = []
    for j in range(E2E_BATCHES):
        batch = picks[j * BATCH : (j + 1) * BATCH]
        results.append((batch, store.batch_similarity_search_with_score(
            [texts[i] for i in batch], k=K)))
    query_s = time.perf_counter() - t0
    for batch, res in results:
        for i, hits in zip(batch, res):
            check(len(hits) == K, f"query d{i}: {len(hits)} hits")
            for doc, score in hits:
                check(isinstance(doc, Document) and store.get_by_ids([doc.id])[0] is doc,
                      "a result is not a Document of the store")
                check(np.isfinite(score), "non-finite score")
            got = [d.id for d, _ in hits]
            hits_top10 += f"d{i}" in got
            hits_top1 += got[0] == f"d{i}"
    n_q = E2E_BATCHES * BATCH
    stages = get_tracer().summary()
    report(f"{n_q} verbatim queries in {query_s:.3f} s = {n_q / query_s:.1f} QPS "
           f"(text → tokenize → encode → search → Documents, B={BATCH})")
    report("store stages, mean ms per batch (host clock): " + ", ".join(
        f"{name} {v['mean_ms']:.3f}" for name, v in sorted(stages.items())))
    report(f"source document in top 10: {hits_top10}/{n_q} = {hits_top10 / n_q:.4f}; "
           f"top 1: {hits_top1 / n_q:.4f}")
    check(hits_top10 >= 0.99 * n_q, f"only {hits_top10}/{n_q} sources in the top 10")

    retriever = store.as_retriever(search_kwargs={"k": K})
    found = 0
    t0 = time.perf_counter()
    for i in picks[:N_SINGLE]:
        docs = retriever.invoke(texts[i])
        check(len(docs) == K and all(isinstance(d, Document) for d in docs),
              "retriever did not return k Documents")
        found += docs[0].id == f"d{i}"
    single_ms = (time.perf_counter() - t0) / N_SINGLE * 1e3
    report(f"retriever.invoke: {N_SINGLE} single queries, {single_ms:.2f} ms each, "
           f"source first in {found}/{N_SINGLE}")
    check(found >= N_SINGLE - 1, f"retriever found {found}/{N_SINGLE} sources first")
    launches = sm.launches  # read before the layer timing below launches more
    report(f"kernel launches in the end-to-end run: {launches}")
    check(launches >= E2E_BATCHES, f"kernel launched {launches} times end to end")
    layer_times(torch, sm, store, emb, [texts[i] for i in picks[:BATCH]])
    return launches, emb, texts, store


def phase_end_to_end_i8(torch, smi8, dev, emb, texts) -> int:
    from rag_arc_tpu_torch.index.persistence import load_store, save_store
    from rag_arc_tpu_torch.index.vector_store import Document, TorchVectorStore

    phase(f"end to end, int8: the same encoder, {I8_DOCS} documents, capacity "
          f"{STORE_CAPACITY}, then a snapshot round trip")
    docs, ids = texts[:I8_DOCS], [f"d{i}" for i in range(I8_DOCS)]
    smi8.launches = 0
    t0 = time.perf_counter()
    store = TorchVectorStore.from_texts(
        docs, emb, ids=ids, capacity=STORE_CAPACITY, dtype=torch.int8, device=dev
    )
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    report(f"ingest {I8_DOCS} docs in {ingest_s:.2f} s = {I8_DOCS / ingest_s:.1f} docs/s; "
           f"refine {store.index.refine}, gap rows {store.index._gap_rows}")
    check(len(store) == I8_DOCS, f"int8 store holds {len(store)} documents")

    picks = np.random.default_rng(SEED + 2).choice(I8_DOCS, size=BATCH, replace=False)
    batch = [docs[i] for i in picks]
    t0 = time.perf_counter()
    res = store.batch_similarity_search_with_score(batch, k=K)
    batch_ms = (time.perf_counter() - t0) * 1e3
    top10 = top1 = 0
    for i, hits in zip(picks, res):
        check(len(hits) == K and all(isinstance(d, Document) and np.isfinite(s)
                                     for d, s in hits), f"int8 query d{i}: bad hits")
        got = [d.id for d, _ in hits]
        top10 += f"d{i}" in got
        top1 += got[0] == f"d{i}"
    report(f"one batch of {BATCH} verbatim texts in {batch_ms:.1f} ms (host clock, "
           f"first int8 batch); source in top 10: {top10}/{BATCH} = {top10 / BATCH:.4f}; "
           f"top 1: {top1 / BATCH:.4f}")
    check(top10 >= 0.99 * BATCH, f"int8: only {top10}/{BATCH} sources in the top 10")
    batch_launches = smi8.launches
    check(batch_launches >= 1, "the int8 kernel did not launch on the batch path")

    retriever = store.as_retriever(search_kwargs={"k": K})
    found = 0
    for i in picks[:I8_SINGLE]:
        got = retriever.invoke(docs[i])
        check(len(got) == K and all(isinstance(d, Document) for d in got),
              "int8 retriever did not return k Documents")
        found += got[0].id == f"d{i}"
    launches = smi8.launches
    report(f"retriever.invoke: {I8_SINGLE} single queries, source first in "
           f"{found}/{I8_SINGLE}; int8 kernel launches: batch {batch_launches}, "
           f"batch + retriever {launches}")
    check(found >= I8_SINGLE - 1, f"int8 retriever found {found}/{I8_SINGLE} sources first")
    check(launches >= batch_launches + I8_SINGLE,
          "the int8 kernel did not launch on the retriever path")

    snap_root = ROOT / "rag_arc_tpu_torch" / "_build"
    snap_root.mkdir(parents=True, exist_ok=True)
    snap = Path(tempfile.mkdtemp(prefix="snapshot-", dir=snap_root))
    try:
        t0 = time.perf_counter()
        save_store(store, snap)
        loaded = load_store(snap, emb, device=dev)
        round_s = time.perf_counter() - t0
        a, b = store.index, loaded.index
        n = a.size
        same = {name: bool(torch.equal(getattr(a, name)[:n], getattr(b, name)[:n]))
                for name in ("emb", "sqnorm", "res", "res_scale", "valid")}
        report(f"snapshot save + load in {round_s:.2f} s; bit-equal: {same}; size "
               f"{b.size}, gap rows {b._gap_rows}, refine {b.refine}")
        check(all(same.values()) and (b.size, b._gap_rows, b.refine, b.n_deleted) ==
              (a.size, a._gap_rows, a.refine, a.n_deleted), "snapshot arrays differ")
        again = loaded.batch_similarity_search_with_score(batch, k=K)
        identical = all([(d.id, s) for d, s in x] == [(d.id, s) for d, s in y]
                        for x, y in zip(res, again))
        report(f"loaded store, the same batch: ids and scores identical: {identical}")
        check(identical, "results of the loaded snapshot differ")
    finally:
        shutil.rmtree(snap, ignore_errors=True)
    del store, loaded
    torch.cuda.empty_cache()
    return launches


def rope_inputs(torch, gen, b, l, nh, nkv, d, dtype, dev):
    """q/k/v as the column slices of one fused qkv projection output (the
    model's layout), left-padded positions, the rope tables, norm scales."""
    from rag_arc_tpu_torch.ops.rope_prep import rope_cos_sin

    qkv = torch.randn(b, l, (nh + 2 * nkv) * d, generator=gen, device=dev).to(dtype)
    q, k, v = qkv[..., : nh * d], qkv[..., nh * d : (nh + nkv) * d], qkv[..., (nh + nkv) * d :]
    mask = left_pad_mask(torch, gen, b, l, dev)
    pos = torch.clamp(torch.cumsum(mask.long(), 1) - 1, min=0)
    cos, sin = rope_cos_sin(pos, 1e6, d)
    qs = torch.rand(d, generator=gen, device=dev) + 0.5
    ks = torch.rand(d, generator=gen, device=dev) + 0.5
    return q, k, v, cos, sin, qs, ks


def left_pad_mask(torch, gen, b, l, dev):
    """(B, L) bool, row 0 unpadded, the rest with random left-pad lengths."""
    live = torch.randint(1, l + 1, (b,), generator=gen, device=dev)
    live[0] = l
    return torch.arange(l, device=dev)[None, :] >= (l - live)[:, None]


def phase_rope(torch, rp, dev) -> dict:
    phase("kernel against its plain version: rope_prep")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    max_err = 0.0
    for b, l, nh, nkv, d, dt_name in ROPE_CASES:
        dtype = torch.bfloat16 if dt_name == "bf16" else torch.float32
        q, k, v, cos, sin, qs, ks = rope_inputs(torch, gen, b, l, nh, nkv, d, dtype, dev)
        got = rp.rope_prep(q, k, v, cos, sin, qs, ks, nh=nh, nkv=nkv, d=d)
        torch.cuda.synchronize()
        want = rp.rope_prep_plain(q.reshape(b, l, nh, d), k.reshape(b, l, nkv, d),
                                  v.reshape(b, l, nkv, d), cos, sin, qs, ks)
        atol, rtol = ROPE_TOL[dt_name]
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        ok = all(bool(((g.float() - w.float()).abs() <= atol + rtol * w.float().abs()).all())
                 for g, w in zip(got, want))
        v_exact = bool(torch.equal(got[2], want[2]))
        max_err = max(max_err, err)
        report(f"{dt_name} B={b} L={l} nh/nkv={nh}/{nkv} D={d}, "
               f"left-padded positions, norm folded: max|kernel - plain| = {err:.3e} "
               f"(bound {atol:g} + {rtol:g}|plain|), V exact: {v_exact}")
        check(all(g.shape == (b, nh, l, d) for g in got), "rope_prep output shape")
        check(ok and v_exact, f"rope_prep disagrees with its plain version: {err}")
    del q, k, v, got, want

    b, l, nh, nkv, d = RERANK_B, RERANK_L, 16, 8, 128
    q, k, v, cos, sin, qs, ks = rope_inputs(torch, gen, b, l, nh, nkv, d, torch.bfloat16, dev)
    kernel = lambda: rp.rope_prep(q, k, v, cos, sin, qs, ks, nh=nh, nkv=nkv, d=d)  # noqa: E731
    plain = lambda: rp.rope_prep_plain(  # noqa: E731
        q.reshape(b, l, nh, d), k.reshape(b, l, nkv, d), v.reshape(b, l, nkv, d),
        cos, sin, qs, ks)
    # bytes: q, k, v and the f32 tables read once; three (B, NH, L, D) outputs
    read = 2 * b * l * (nh + 2 * nkv) * d + 2 * 4 * b * l * d
    moved = read + 3 * 2 * b * nh * l * d
    timed = in_turns(kernel, plain, f"rope_prep bf16 B={b} L={l} nh/nkv={nh}/{nkv} D={d}",
                     moved, "TB/s moved (reads + writes)", read, "read")
    del q, k, v, cos, sin
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, **timed, **bound(0.0, H100_BF16_PEAK, moved),
            "library_ms": None}


def attn_inputs(torch, gen, b, h, l, d, dtype, dev):
    q, k, v = (torch.randn(b, h, l, d, generator=gen, device=dev).to(dtype) for _ in range(3))
    seg = left_pad_mask(torch, gen, b, l, dev).to(torch.int32)
    return q, k, v, seg


def phase_flash(torch, fa, dev) -> dict:
    phase("kernel against its plain version: flash_attention (causal, segment ids)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    max_err = 0.0
    for b, h, l, d, dt_name in FLASH_CASES:
        dtype = torch.bfloat16 if dt_name == "bf16" else torch.float32
        q, k, v, seg = attn_inputs(torch, gen, b, h, l, d, dtype, dev)
        got = fa.flash_attention(q, k, v, seg)
        torch.cuda.synchronize()
        want = fa.attention_plain(q, k, v, seg, causal=True, sm_scale=d ** -0.5)
        atol, rtol = FLASH_TOL[dt_name]
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= atol + rtol * want.float().abs()).all())
        finite = bool(torch.isfinite(got).all())
        max_err = max(max_err, err)
        report(f"{dt_name} B={b} H={h} L={l} D={d}, left-padded, "
               f"every row: max|kernel - plain| = {err:.3e} (bound {atol:g} + "
               f"{rtol:g}|plain|), finite: {finite}, pad rows "
               f"{int((seg == 0).sum())}")
        check(finite and ok, f"flash_attention disagrees with its plain version: {err}")
        del got, want, diff

    b, h, l, d = RERANK_B, 16, RERANK_L, 128
    q, k, v, seg = attn_inputs(torch, gen, b, h, l, d, torch.bfloat16, dev)
    kernel = lambda: fa.flash_attention(q, k, v, seg)  # noqa: E731
    plain = lambda: fa.attention_plain(q, k, v, seg, causal=True, sm_scale=d ** -0.5)  # noqa: E731
    flops = 4.0 * b * h * l * l * d / 2  # the causal half
    nbytes = 4 * b * h * l * d * 2 + 4 * b * l
    timed = in_turns(kernel, plain, f"flash_attention bf16 B={b} H={h} L={l} D={d} causal",
                     flops, "TFLOP/s", nbytes, "of Q, K, V, out")
    # the library yardstick: SDPA with the boolean mask causal & same
    # segment; under the segment rule no row is fully masked
    causal = torch.ones(l, l, dtype=torch.bool, device=dev).tril()
    mask = causal[None, None] & (seg[:, None, :, None] == seg[:, None, None, :])
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, scale=d ** -0.5)
    lib_err = float((lib().float() - kernel().float()).abs().max())
    lib_ms = library_ms(lib, f"scaled_dot_product_attention bf16 B={b} H={h} L={l} D={d}, "
                        f"causal & segment mask (max|library - kernel| {lib_err:.3e})")
    del q, k, v, seg, mask
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, **timed, **bound(flops, H100_BF16_PEAK, nbytes),
            "library_ms": lib_ms}


def rerank_flops_per_pair(cfg, length: int) -> float:
    """Matmul FLOPs of one pair's forward, as bench.py:421-429 counts them
    (qkvo + SwiGLU per layer, plus 4·L·NH·D attention per token)."""
    h, hd, nh, nkv, inter = (cfg.hidden_size, cfg.head_dim, cfg.num_attention_heads,
                             cfg.num_key_value_heads, cfg.intermediate_size)
    per_layer = 2 * h * hd * (2 * nh + 2 * nkv) + 6 * h * inter
    attn = 4 * length * nh * hd
    return float(length * cfg.num_hidden_layers * (per_layer + attn))


def p_yes(torch, logits, yes_id: int, no_id: int):
    pair = torch.stack([logits[:, no_id], logits[:, yes_id]], dim=-1).float()
    return torch.softmax(pair, dim=-1)[:, 1]


def qwen3_layer_times(torch, model, rp, fa, ids, mask) -> None:
    """Device time of each stage of layer 0 at the rerank shape."""
    import math

    from rag_arc_tpu_torch.models.qwen3 import _linear

    cfg = model.cfg
    layer, attn = model.layers[0], model.layers[0].self_attn
    hd, nh, nkv, dt = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads, cfg.dtype
    ctx = model._context(mask)
    with torch.inference_mode():
        x = model.embed_tokens(ids).to(dt)
        h = layer.input_layernorm(x)
        qkv = _linear(attn.qkv_proj, h, dt)
        q, k, v = qkv[..., : nh * hd], qkv[..., nh * hd : (nh + nkv) * hd], qkv[..., (nh + nkv) * hd :]
        qn, ks = attn.q_norm.weight.float(), attn.k_norm.weight.float()
        qr, kr, vr = rp.rope_prep(q, k, v, ctx.cos, ctx.sin, qn, ks, nh=nh, nkv=nkv, d=hd)
        out = fa.flash_attention(qr, kr, vr, ctx.seg, sm_scale=1.0 / math.sqrt(hd))
        flat = out.transpose(1, 2).reshape(x.shape[0], x.shape[1], nh * hd)

        def mlp():
            gu = _linear(layer.gateup_proj, layer.post_attention_layernorm(x), dt)
            gate, up = gu[..., : cfg.intermediate_size], gu[..., cfg.intermediate_size :]
            return _linear(layer.down_proj, torch.nn.functional.silu(gate) * up, dt)

        stages = {
            "input RMSNorm": lambda: layer.input_layernorm(x),
            "qkv projection": lambda: _linear(attn.qkv_proj, h, dt),
            "rope_prep": lambda: rp.rope_prep(q, k, v, ctx.cos, ctx.sin, qn, ks, nh=nh,
                                              nkv=nkv, d=hd),
            "attention": lambda: fa.flash_attention(qr, kr, vr, ctx.seg,
                                                    sm_scale=1.0 / math.sqrt(hd)),
            "(B,H,L,D)->(B,L,H*D) copy": lambda: out.transpose(1, 2).reshape(flat.shape),
            "o_proj": lambda: _linear(attn.o_proj, flat, dt),
            "MLP (norm, gate|up, SiLU*up, down)": mlp,
            "whole layer": lambda: layer(x, ctx),
        }
        times = {}
        for name, fn in stages.items():
            # a first call outside the window: first-use allocations stall
            # the host, and CUDA events would count the device's idle gap
            fn()
            torch.cuda.synchronize()
            times[name] = cuda_ms(fn, 10)
    report(f"layer 0 of {cfg.num_hidden_layers}, B={ids.shape[0]} L={ids.shape[1]} bf16 "
           f"(CUDA events, mean of 10): " + ", ".join(f"{n} {t:.3f} ms" for n, t in times.items()))


def phase_rerank_model(torch, rp, fa, dev):
    """Qwen3-0.6B widths, seeded N(0, 0.02) bf16 weights, last_logits at
    B=64 x L=512 on the kernel path, timed and held against the einsum
    path; then an f32 check at full width and 2 layers. Returns the model
    and its einsum-path twin (the same weights)."""
    import dataclasses

    from rag_arc_tpu_torch.models.qwen3 import Qwen3Config, Qwen3LM, init_qwen3
    from rag_arc_tpu_torch.rerank.cross_encoder import HashTokenizer

    cfg = Qwen3Config(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    phase(f"rerank model: Qwen3 {cfg.num_hidden_layers}x{cfg.hidden_size}, heads "
          f"{cfg.num_attention_heads}/{cfg.num_key_value_heads}x{cfg.head_dim}, vocab "
          f"{cfg.vocab_size}, bf16 (seeded N(0, 0.02) weights), last_logits at "
          f"B={RERANK_B} L={RERANK_L}")
    t0 = time.perf_counter()
    model = init_qwen3(cfg, SEED, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    report(f"{n_params / 1e6:.1f}M parameters made on the card in "
           f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    ids = torch.randint(4, cfg.vocab_size, (RERANK_B, RERANK_L), generator=gen, device=dev)
    full = torch.ones_like(ids, dtype=torch.bool)

    with torch.inference_mode():
        model.last_logits(ids, full)  # warm up
        torch.cuda.synchronize()
        Counter(rp).reset()
        Counter(fa).reset()
        fwd_ms = cuda_ms(lambda: model.last_logits(ids, full), RERANK_REPS)
        launches = (rp.launches, fa.launches)
    per_fwd = tuple(n // RERANK_REPS for n in launches)
    pairs_s = RERANK_B / (fwd_ms / 1e3)
    flops = rerank_flops_per_pair(cfg, RERANK_L)
    mfu = pairs_s * flops / H100_BF16_PEAK
    report(f"last_logits forward {fwd_ms:.3f} ms (CUDA events, mean of {RERANK_REPS}): "
           f"{pairs_s:.1f} pairs/s, {1e3 * 50 / pairs_s:.2f} ms per 50-candidate query, "
           f"MFU {100 * mfu:.2f}% of 989 TFLOP/s dense bf16 ({flops * RERANK_B / 1e12:.2f} "
           f"TFLOP a batch, bench.py:421-429 count); launches per forward: rope_prep "
           f"{per_fwd[0]}, flash_attention {per_fwd[1]}")
    check(per_fwd == (cfg.num_hidden_layers,) * 2,
          f"launches per forward {per_fwd}, want {cfg.num_hidden_layers} each")

    mask = left_pad_mask(torch, gen, RERANK_B, RERANK_L, dev)
    qwen3_layer_times(torch, model, rp, fa, ids, mask)

    ref = Qwen3LM(dataclasses.replace(cfg, attn_impl="einsum"), device=dev)
    ref.load_state_dict(model.state_dict())
    ref.eval()
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    yes, no = tok.token_id("yes"), tok.token_id("no")
    with torch.inference_mode():
        got = model.last_logits(ids, mask).float()
        ref_ms = cuda_ms(lambda: ref.last_logits(ids, mask), 1)
        want = ref.last_logits(ids, mask).float()
    d_logit = float((got - want).abs().max())
    d_p = float((p_yes(torch, got, yes, no) - p_yes(torch, want, yes, no)).abs().max())
    report(f"kernel path vs einsum path, same weights, left-padded batch "
           f"({int((~mask).sum())} pad slots): max|Δ last logit| = {d_logit:.3e} (bound "
           f"{LOGIT_BOUND}; |logit| up to {float(want.abs().max()):.3f}), max|ΔP(yes)| = "
           f"{d_p:.3e} (bound {P_BOUND}); einsum forward {ref_ms:.1f} ms")
    check(bool(torch.isfinite(got).all()), "non-finite logits on the kernel path")
    check(d_logit <= LOGIT_BOUND and d_p <= P_BOUND, "kernel path strays from the einsum path")
    del got, want

    cfg32 = Qwen3Config(num_hidden_layers=2)
    m32 = init_qwen3(cfg32, SEED + 1, dev)
    r32 = Qwen3LM(dataclasses.replace(cfg32, attn_impl="einsum"), device=dev)
    r32.load_state_dict(m32.state_dict())
    ids32, mask32 = ids[:F32_B, :F32_L], left_pad_mask(torch, gen, F32_B, F32_L, dev)
    with torch.inference_mode():
        d32 = float((m32.last_logits(ids32, mask32) - r32.last_logits(ids32, mask32))
                    .abs().max())
    report(f"f32, {cfg32.num_hidden_layers} layers at full width, B={F32_B} L={F32_L} "
           f"left-padded: max|Δ last logit| kernel vs einsum = {d32:.3e} (bound {F32_BOUND})")
    check(d32 <= F32_BOUND, f"f32 kernel path strays from the einsum path: {d32}")
    del m32, r32
    torch.cuda.empty_cache()
    return model, ref


def rerank_order_inversions(got, ref) -> tuple[int, float]:
    """Pairs of candidates that the two rankings order differently, and
    the largest score gap (in the first ranking) among them."""
    score_a = {d.id: d.metadata["rerank_score"] for d in got}
    pos_b = {d.id: i for i, d in enumerate(ref)}
    n, gap = 0, 0.0
    for i, a in enumerate(got):
        for c in got[i + 1 :]:
            if pos_b[a.id] > pos_b[c.id]:
                n += 1
                gap = max(gap, score_a[a.id] - score_a[c.id])
    return n, gap


def phase_rerank_e2e(torch, rp, fa, dev, store, texts, model, ref) -> tuple[int, int]:
    """``model`` on the kernel path, ``ref`` its einsum-path twin."""
    from rag_arc_tpu_torch.index.vector_store import Document
    from rag_arc_tpu_torch.rerank.cross_encoder import CrossEncoderReranker, HashTokenizer

    phase(f"retrieve -> rerank: top {RERANK_CANDIDATES} of the e2e store for "
          f"{RERANK_QUERIES} query texts, reranked to {K} by the Qwen3 cross-encoder")
    picks = np.random.default_rng(SEED + 6).choice(len(texts), RERANK_QUERIES, replace=False)
    queries = [texts[i] for i in picks]
    hits = store.batch_similarity_search_with_score(queries, k=RERANK_CANDIDATES)
    cands = [[d for d, _ in h] for h in hits]
    check(all(len(c) == RERANK_CANDIDATES for c in cands), "retrieval came back short")
    tok = HashTokenizer(vocab_size=model.cfg.vocab_size)
    rr = CrossEncoderReranker.from_causal_lm(model, None, tok, device=dev)
    rr.rerank_batch(queries[:1], cands[:1], k=K)  # warm up
    torch.cuda.synchronize()

    Counter(rp).reset()
    Counter(fa).reset()
    t0 = time.perf_counter()
    out = rr.rerank_batch(queries, cands, k=K)
    e2e_s = time.perf_counter() - t0
    launches = (rp.launches, fa.launches)
    n_pairs = RERANK_QUERIES * RERANK_CANDIDATES
    bucket = rr._encode_bucketed(
        [rr._render(q, d.content) for q, c in zip(queries, cands) for d in c])[0].shape[1]
    report(f"rerank_batch of {n_pairs} pairs in {e2e_s * 1e3:.1f} ms (host clock, ends in "
           f"the readback) = {n_pairs / e2e_s:.1f} pairs/s; kernel launches rope_prep "
           f"{launches[0]}, flash_attention {launches[1]}")
    check(min(launches) >= model.cfg.num_hidden_layers,
          f"the rerank path launched the kernels {launches} times")
    for q, c, res in zip(queries, cands, out):
        scores = [d.metadata["rerank_score"] for d in res]
        check(len(res) == K and all(isinstance(d, Document) for d in res),
              "rerank did not return k Documents")
        check({d.id for d in res} <= {d.id for d in c}, "a reranked result is not a candidate")
        check(scores == sorted(scores, reverse=True), "results not sorted by rerank_score")
        check(all(0.0 <= s <= 1.0 for s in scores), "a rerank score outside [0, 1]")

    rr_ref = CrossEncoderReranker.from_causal_lm(ref, None, tok, device=dev)
    full = rr.rerank_batch(queries, cands)
    full_ref = rr_ref.rerank_batch(queries, cands)
    n_inv, gap, d_p = 0, 0.0, 0.0
    for a, b in zip(full, full_ref):
        n, g = rerank_order_inversions(a, b)
        n_inv, gap = n_inv + n, max(gap, g)
        ref_score = {d.id: d.metadata["rerank_score"] for d in b}
        d_p = max([d_p] + [abs(x.metadata["rerank_score"] - ref_score[x.id]) for x in a])
    spread = max(a[0].metadata["rerank_score"] - a[-1].metadata["rerank_score"] for a in full)
    report(f"full order vs the einsum path: {n_inv} inverted pairs, widest score gap among "
           f"them {gap:.3e} (bound {2 * P_BOUND}), max|ΔP(yes)| {d_p:.3e} (bound {P_BOUND}); "
           f"widest score spread in a candidate set {spread:.3e}; prompts in the "
           f"{bucket}-token bucket")
    check(d_p <= P_BOUND and gap <= 2 * P_BOUND, "rerank order differs beyond the bound")
    del rr_ref, full, full_ref

    default = CrossEncoderReranker(device=dev)
    c = default.cfg
    t0 = time.perf_counter()
    out = default.rerank_batch(queries, cands, k=K)
    default_s = time.perf_counter() - t0
    ok = all(len(r) == K and all(0.0 <= d.metadata["rerank_score"] <= 1.0 for d in r) and
             [d.metadata["rerank_score"] for d in r] ==
             sorted((d.metadata["rerank_score"] for d in r), reverse=True) for r in out)
    report(f"default CrossEncoderReranker() ({c.dim}x{c.depth} causal, vocab {c.vocab_size}, "
           f"seeded weights): rerank_batch of {n_pairs} pairs in {default_s * 1e3:.1f} ms "
           f"(host clock, first call); sorted, scores in [0, 1]: {ok}")
    check(ok, "the default reranker's results are not sorted scores in [0, 1]")
    del default
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from rag_arc_tpu_torch.ops import subtile_max as sm
    from rag_arc_tpu_torch.ops import flash_attention as fa
    from rag_arc_tpu_torch.ops import rope_prep as rp
    from rag_arc_tpu_torch.ops import subtile_max_i8 as smi8
    from rag_arc_tpu_torch.ops import subtile_max_piped as smp
    from rag_arc_tpu_torch.ops import fused_mips as fm
    from rag_arc_tpu_torch.ops import corpus_stream as cst

    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    try:
        phase_environment(torch)
        phase_build([sm, smi8, rp, fa, smp, fm, cst])
        kernel, kernel_l2 = phase_kernel(torch, sm, dev)
        kernel_i8 = phase_kernel_i8(torch, smi8, dev)
        kernel_rope = phase_rope(torch, rp, dev)
        kernel_flash = phase_flash(torch, fa, dev)
        kernel_piped = phase_kernel_piped(torch, sm, smi8, smp, dev)
        kernel_fused = phase_kernel_fused(torch, fm, dev)
        kernel_stream = phase_kernel_stream(torch, cst, dev)
        probe_launches = phase_probe(torch, smp, fm, cst, dev)
        data = make_index_data(torch, dev)
        phase_index(torch, sm, dev, data)
        l2_launches = phase_index_l2(torch, sm, dev, data)
        phase_index_i8(torch, smi8, dev, data)
        del data
        e2e_launches, emb, texts, store = phase_end_to_end(torch, sm, dev)
        i8_launches = phase_end_to_end_i8(torch, smi8, dev, emb, texts)
        qwen3, qwen3_ref = phase_rerank_model(torch, rp, fa, dev)
        rope_launches, flash_launches = phase_rerank_e2e(
            torch, rp, fa, dev, store, texts, qwen3, qwen3_ref)
        del store, qwen3, qwen3_ref
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    print(f"== done in {time.perf_counter() - t_all:.1f} s", flush=True)
    src = "rag_arc_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        {"name": "subtile_max", "route": "cuda", "source": src + "subtile_max.cu",
         "replaces": "rag_arc_tpu/ops/two_level_stream.py:140",
         "also_replaces": "rag_arc_tpu/ops/two_level.py:89",
         "launches": e2e_launches, **kernel},
        {"name": "subtile_max_l2", "route": "cuda", "source": src + "subtile_max.cu",
         "replaces": "rag_arc_tpu/ops/two_level.py:59",
         "launches": l2_launches, **kernel_l2},
        {"name": "subtile_max_i8", "route": "cuda", "source": src + "subtile_max_i8.cu",
         "replaces": "rag_arc_tpu/ops/two_level.py:139",
         "also_replaces": ["rag_arc_tpu/ops/two_level_stream.py:140 (int8 mode)",
                           "rag_arc_tpu/ops/two_level.py:109"],
         "launches": i8_launches, **kernel_i8},
        {"name": "rope_prep", "route": "cuda", "source": src + "rope_prep.cu",
         "replaces": "rag_arc_tpu/ops/rope_prep.py:52",
         "launches": rope_launches, **kernel_rope},
        {"name": "flash_attention", "route": "cuda", "source": src + "flash_attention.cu",
         "replaces": "rag_arc_tpu/models/qwen3.py:176-196 (library Pallas flash attention)",
         "launches": flash_launches, **kernel_flash},
        {"name": "subtile_max_piped", "route": "cuda", "source": src + "subtile_max_piped.cu",
         "replaces": "rag_arc_tpu/ops/two_level_stream.py:53",
         "launches": probe_launches["subtile_max_piped"], **kernel_piped},
        {"name": "fused_mips_topk", "route": "cuda", "source": src + "fused_mips.cu",
         "replaces": "rag_arc_tpu/ops/fused_mips.py:50",
         "launches": probe_launches["fused_mips_topk"], **kernel_fused},
        {"name": "corpus_stream", "route": "cuda", "source": src + "corpus_stream.cu",
         "replaces": "tools/kernel_probe.py:194",
         "launches": probe_launches["corpus_stream"], **kernel_stream},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
