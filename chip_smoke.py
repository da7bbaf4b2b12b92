#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines and times:

  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: compile both CUDA kernels from ``rag_arc_tpu_torch/csrc`` for
     sm_90a, one ``nvcc`` each, in parallel (nvcc's register / shared-memory
     report is printed);
  3. kernels against their plain PyTorch versions on the card (N = 262,144,
     d = 768, g = 16, ~3% dead rows), then compared again and timed in
     turns at B = 512, N = 2M:
     - ``subtile_max``: bf16 B in {1, 7, 128, 512}, f32 B = 64;
     - its l2 mode: bf16 B in {7, 512}, f32 B = 64;
     - ``subtile_max_i8``: block scales B in {1, 7, 128, 512}, per-row
       scales B = 64, exactly equal; at N = 2M both scale modes;
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
       into a fresh store, with arrays and results compared bit for bit.

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


def in_turns(kernel, plain, name: str, ops: float, unit: str, bytes_read: float) -> dict:
    """Time kernel and plain version in turns (plain, kernel, kernel,
    plain) and report both, with the kernel's rate."""
    p1 = cuda_ms(plain, 3)
    k1 = cuda_ms(kernel, 10)
    k2 = cuda_ms(kernel, 10)
    p2 = cuda_ms(plain, 3)
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    report(f"{name}: kernel {k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms "
           f"(CUDA events; in turns plain, kernel, kernel, plain); kernel "
           f"{ops / kernel_ms / 1e9:.1f} {unit}, {bytes_read / kernel_ms / 1e6:.1f} GB/s "
           f"of corpus")
    return {"ms": kernel_ms, "plain_ms": plain_ms}


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
    report(f"both kernels ready in {time.perf_counter() - t0:.2f} s")
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
    return {"max_abs_err": max_err, **ip}, {"max_abs_err": l2_err, **l2}


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
    return {"max_abs_err": max_err, **timed,
            "per_row_ms": per_row["ms"], "per_row_plain_ms": per_row["plain_ms"]}


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
    del store
    torch.cuda.empty_cache()
    return launches, emb, texts


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from rag_arc_tpu_torch.ops import subtile_max as sm
    from rag_arc_tpu_torch.ops import subtile_max_i8 as smi8

    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    try:
        phase_environment(torch)
        phase_build([sm, smi8])
        kernel, kernel_l2 = phase_kernel(torch, sm, dev)
        kernel_i8 = phase_kernel_i8(torch, smi8, dev)
        data = make_index_data(torch, dev)
        phase_index(torch, sm, dev, data)
        l2_launches = phase_index_l2(torch, sm, dev, data)
        phase_index_i8(torch, smi8, dev, data)
        del data
        e2e_launches, emb, texts = phase_end_to_end(torch, sm, dev)
        i8_launches = phase_end_to_end_i8(torch, smi8, dev, emb, texts)
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
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
