"""A/B of this tree's IVF probe scan and sub-tile select kernels against
another tree's (an earlier commit of this repository), in turns on one
card; the scan's path and tile sweeps; the kernels one IVF dispatch
launches; and the card's yardstick (peak rates, the bound, CUDA-event
timing) that ``chip_smoke.py`` uses too.

    mkdir -p .checkout/parent && git archive <commit> | tar -x -C .checkout/parent
    python -m rag_arc_tpu_torch.tools.kernel_ab --parent .checkout/parent

builds the other tree's ``csrc/ivf_scan.cu`` and ``csrc/subtile_select.cu``
beside this tree's and binds them through the C entries their exports
show (:class:`OtherKernels`; an interface it does not know is refused),
then times each pair in turns (other, this, this, other) on the same
inputs, and checks that both agree:

- the scan's two paths forced by mean group size (the wgmma crossover)
  and the pair grid's tile and ring (``scan_schedule``'s small-B plan);
- the scan on ``tools/ivf_oracle.py``'s clustered 1M x 768 corpus, a bf16
  IVF of 100 lists, at B 1 / 8 / 32 / 256 and nprobe 8 / 32;
- the select on a B=512 batch's sub-tile maxima over 2M x 768 unit rows
  (C = 125,000; ``chip_smoke.py``'s slab) at B 512 / 256 / 160 and k 10 /
  100, and at the shapes the other paths send it: an int8 flat search's
  (B 1 / 8 / 32, k = kf = 20), an IVF dispatch's and a BM25 batch's (the
  group maxima of their score buffers, B=32).

``--select`` runs the select A/B alone. ``--dense`` instead times a
2M x 768 bf16 flat index's B=512 search and sustained QPS, and a 2M x
768 int8 index's search at B 1 / 8 / 32, with the other tree's select in
this one's place, in turns; ``--other-split 1,4`` times each listed
split where the other select has a cluster split.

    python rag_arc_tpu_torch/tools/kernel_ab.py --search

(run with ``PYTHONPATH`` set to either tree) counts the device kernels
``torch.profiler`` sees in one ``search_sub`` at B = 1 and 32, nprobe 8,
and B = 32, nprobe 32, and times ``search_sub`` at B 1 / 8 / 32 and
nprobe 8 / 32 (CUDA events). Every line names the card and its power
limit; the run exits non-zero where two kernels disagree.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import subprocess
import time
from pathlib import Path

import torch

H100_BF16_PEAK = 989e12  # dense bf16 FLOP/s, NVIDIA's data sheet (SXM, 700 W)
H100_INT8_PEAK = 1979e12  # dense int8 OP/s, the same sheet
H100_F32_PEAK = 67e12  # f32 FLOP/s outside the tensor cores, the same sheet
H100_HBM = 3.35e12  # HBM3 bytes/s, the same sheet
SCAN_B = (1, 8, 32, 256)
SCAN_NPROBE = (8, 32)
CROSSOVER = ((1, 8), (8, 8), (16, 8), (8, 32), (32, 8), (48, 8), (64, 8), (32, 32), (256, 8),
             (256, 32), (1024, 8))
TILE_SWEEP = ((1, 8), (1, 32), (4, 8), (8, 8))  # pair-grid shapes: B·nprobe < 100 lists
TILE_ROWS = (32, 64, 128, 256)
SELECT_B = (512, 256, 160)
SELECT_K = (10, 100)
# (label, B, C, k) of the select where the other paths send it
SELECT_PATHS = (("int8 flat search", 1, 125_000, 20), ("int8 flat search", 8, 125_000, 20),
                ("int8 flat search", 32, 125_000, 20),
                ("IVF dispatch, nprobe 8", 32, 462, 10), ("BM25 batch, 2M docs", 32, 4096, 10))
SCAN_TOL = 1e-5  # f32 sums of 768 exact products in another order; |scores| <= ~2
SLEEP_CYCLES = 20_000_000  # ~11 ms at the H100's clock: the host enqueues a run behind it


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls (CUDA events; a call
    the host issues more slowly than the card runs it counts its host
    time)."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def queued_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds per call with the host ahead of the card: a
    sleep kernel holds the stream while the host enqueues every call, so
    each call's kernels and the gaps between them count, its host work
    does not (CUDA events; after one untimed call)."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def bound(ops: float, peak: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the peak rate for their type and the bytes (each input read once,
    each output written once) over the HBM rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / H100_HBM * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def ab_turns(fns: dict, reps: int = 10) -> dict:
    """Each of ``fns`` (name -> call) in turns, forward then backward
    (other, this, this, other for two): ``{name}_ms``, the mean CUDA-event
    ms of each of its two runs, and ``{name}_queued_ms``, its device ms
    with the host ahead (:func:`queued_ms`)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    order = list(fns) + list(reversed(fns))
    out = {f"{name}_ms": [] for name in fns}
    for name in order:
        out[f"{name}_ms"].append(cuda_ms(fns[name], reps))
    for name in order:
        out.setdefault(f"{name}_queued_ms", []).append(queued_ms(fns[name]))
    return out


class OtherKernels:
    """Another tree's scan and select, bound through the C entries its
    libraries export. The scan: the interface with a block per (query,
    64-row tile, probe rank), which exports ``ivf_scan_rows_per_block``
    and no ``ivf_scan_plan_launch``. The select: one block a row (ten
    arguments), or the cluster split's (``subtile_select_max_split``
    exported, an eleventh argument). Any other interface is refused: its
    argument list is unknown here, and a wrong one is undefined behaviour
    on the card."""

    def __init__(self, root: Path):
        from rag_arc_tpu_torch.ops._build import build

        self.root = Path(root).resolve()
        self.csrc = self.root / "rag_arc_tpu_torch" / "csrc"
        i = ctypes.c_int
        p = ctypes.c_void_p
        lib = build("subtile_select", self.csrc).lib
        self.splits = hasattr(lib, "subtile_select_max_split")
        self.select = lib.subtile_select_launch
        self.select.argtypes = [p, i, i, i, p, p, p, p, i] + ([i] if self.splits else []) + [p]
        self.select.restype = i
        lib.subtile_select_scratch_cols.argtypes = [i, i]
        self.scratch_cols = lib.subtile_select_scratch_cols

    @functools.cached_property
    def scan(self):
        """The other scan's C entry (built at first use), or None where its
        interface is not the one bound here."""
        from rag_arc_tpu_torch.ops._build import build

        lib = build("ivf_scan", self.csrc).lib
        if not hasattr(lib, "ivf_scan_rows_per_block") or hasattr(lib, "ivf_scan_plan_launch"):
            return None
        p, l, i = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
        fn = lib.ivf_scan_launch
        fn.argtypes = [p, p, p, l, l, p, p, p, p, p, l, i, i, i, i, i, i, i, i, p]
        fn.restype = i
        return fn

    def ivf_scan(self, q, probe, lists, sqnorm, valid, out):
        """The bf16 / cosine scan into ``out`` (B, nprobe·Lmax)."""
        from rag_arc_tpu_torch.ops.ivf_scan import _prepared

        if self.scan is None:
            raise SystemExit(f"kernel_ab: {self.root}'s ivf_scan exports an interface this "
                             "tool does not bind")
        qc, _ = _prepared(q, lists, "ip")
        nlist, lmax, d = lists.shape
        err = self.scan(qc.data_ptr(), probe.data_ptr(), lists.data_ptr(), lists.stride(0),
                        lists.stride(1), sqnorm.data_ptr(), valid.view(torch.uint8).data_ptr(),
                        None, None, out.data_ptr(), out.stride(0), probe.shape[0],
                        probe.shape[1], lmax, d, nlist, 1, 0, 1,
                        torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"the other tree's scan failed: CUDA error {err}"
        return out

    def iterative_argmax_resid(self, x, k, split: int = 1):
        """The other select's (picked, live, resid); ``split`` blocks a row
        where its interface has the cluster split (else only 1)."""
        if split != 1 and not self.splits:
            raise SystemExit(f"kernel_ab: {self.root}'s select has no cluster split")
        b, c = x.shape
        picked = torch.empty((b, k), dtype=torch.int64, device=x.device)
        live = torch.empty((b, k), dtype=torch.bool, device=x.device)
        resid = torch.empty((b,), dtype=torch.float32, device=x.device)
        assert self.scratch_cols(c, k) == 0, "the A/B stays on the shared-buffer route"
        args = [x.data_ptr(), b, c, k, picked.data_ptr(), live.view(torch.uint8).data_ptr(),
                resid.data_ptr(), None, 0] + ([split] if self.splits else [])
        err = self.select(*args, torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"the other tree's select failed: CUDA error {err}"
        return picked, live, resid


def same_select(a, b) -> bool:
    """Live picks, flags and residuals equal."""
    (ai, al, ar), (bi, bl, br) = a, b
    return (torch.equal(al, bl) and torch.equal(torch.where(al, ai, -1), torch.where(bl, bi, -1))
            and torch.equal(ar, br))


def unit_rows(gen, n: int, d: int, dev) -> torch.Tensor:
    x = torch.rand((n, d), generator=gen, device=dev) - 0.5
    return x / torch.linalg.norm(x, dim=1, keepdim=True)


def select_slab(dev, n: int = 2_000_000, d: int = 768, g: int = 16, b: int = 512):
    """``chip_smoke.py``'s select slab: a B=512 batch's sub-tile maxima over
    n unit rows, ~3% dead, queries near rows."""
    from rag_arc_tpu_torch.ops import subtile_max as sm

    gen = torch.Generator(device=dev).manual_seed(10)
    x = unit_rows(gen, n, d, dev).to(torch.bfloat16)
    valid = torch.rand(n, generator=gen, device=dev) > 0.03
    x[~valid] = 0
    pick = torch.randint(0, n, (b,), generator=gen, device=dev)
    q = x[pick].float() + 0.1 * torch.randn((b, d), generator=gen, device=dev)
    q = (q / torch.linalg.norm(q, dim=1, keepdim=True)).to(torch.bfloat16)
    return sm.subtile_max(q, x, valid, g)


def ab_select(other: OtherKernels, slab, label: str) -> list:
    """The two selects in turns on the slab's shapes and the other paths'
    (their columns cut from the slab's front). Each row's ``equal``: live
    picks, flags and residuals the same."""
    from rag_arc_tpu_torch.ops import subtile_select as ss

    shapes = [("dense two-level", b, slab.shape[1], k) for b in SELECT_B for k in SELECT_K]
    rows = []
    for what, b, c, k in shapes + list(SELECT_PATHS):
        x = slab[:b, :c].contiguous()
        ok = same_select(ss.iterative_argmax_resid(x, k), other.iterative_argmax_resid(x, k))
        t = ab_turns({"other": lambda: other.iterative_argmax_resid(x, k),
                      "this": lambda: ss.iterative_argmax_resid(x, k)})
        row = {"kernel": "subtile_select", "shape_of": what, "b": b, "c": c, "k": k,
               "equal": ok, **t,
               "bound_ms": bound(b * c, H100_F32_PEAK, b * c * 4 + b * k * 9 + b * 4)["bound_ms"]}
        print(json.dumps(row) + f"  [{label}]", flush=True)
        rows.append(row)
    return rows


def scan_operands(index, q, nprobe: int):
    """(q normalized, probe (B, nprobe)) as ``search_sub`` makes them."""
    from rag_arc_tpu_torch.ops.bm25 import full_f32_matmul
    from rag_arc_tpu_torch.ops.scoring import l2_normalize
    from rag_arc_tpu_torch.ops.topk import stable_topk

    q = l2_normalize(q)
    with full_f32_matmul():
        cross = q @ index.centroids.T
    return q, stable_topk(cross, nprobe)[1].contiguous()


def scan_bound(index, probe, b: int) -> tuple[float, float, int]:
    """(ops, bytes, distinct lists) of one bf16 scan: each distinct probed
    list's live rows read once (row + its norm) and its mask, the queries
    read and every score written once; ops 2·B·nprobe·Lmax·d."""
    nprobe = probe.shape[1]
    d, lmax = index.lists.shape[2], index.lmax
    lists = torch.unique(probe)
    live = int(index.valid[lists].sum())
    width = nprobe * lmax
    nbytes = live * (d * 2 + 4) + lists.numel() * lmax + b * width * 4 + b * d * 4
    return 2.0 * b * width * d, nbytes, lists.numel()


def scan_agrees(got, want) -> tuple[bool, float]:
    """(masks equal, max |got - want| over the live slots)."""
    same_mask = torch.equal(torch.isneginf(got), torch.isneginf(want))
    live = torch.isfinite(want)
    err = float((got[live] - want[live]).abs().max()) if bool(live.any()) else 0.0
    return same_mask, err


def ab_scan(other: OtherKernels, index, q_dev, label: str) -> list:
    """The two scans in turns at SCAN_B x SCAN_NPROBE; each row's
    ``masks_equal`` and ``within_tol`` (|this - other| <= SCAN_TOL)."""
    from rag_arc_tpu_torch.ops import ivf_scan as isc

    rows = []
    for b in SCAN_B:
        for nprobe in SCAN_NPROBE:
            q, probe = scan_operands(index, q_dev[:b], nprobe)
            width = nprobe * index.lmax
            mine = torch.empty((b, width), device=q.device)
            theirs = torch.empty((b, width), device=q.device)
            args = (q, probe, index.lists, index.sqnorm, index.valid, "cosine")
            isc.ivf_scan(*args, out=mine)
            other.ivf_scan(q, probe, index.lists, index.sqnorm, index.valid, theirs)
            torch.cuda.synchronize()
            same_mask, err = scan_agrees(mine, theirs)
            t = ab_turns({"other": lambda: other.ivf_scan(q, probe, index.lists, index.sqnorm,
                                                          index.valid, theirs),
                          "this": lambda: isc.ivf_scan(*args, out=mine)})
            ops, nbytes, distinct = scan_bound(index, probe, b)
            row = {"kernel": "ivf_scan", "b": b, "nprobe": nprobe, "lmax": index.lmax,
                   "distinct_lists": distinct, "masks_equal": same_mask, "max_abs_diff": err,
                   "within_tol": err <= SCAN_TOL, **t,
                   "bound_ms": bound(ops, H100_BF16_PEAK, nbytes)["bound_ms"]}
            print(json.dumps(row) + f"  [{label}]", flush=True)
            rows.append(row)
    return rows


@contextlib.contextmanager
def scan_settings(**over):
    """``ops/ivf_scan.py``'s module settings (``TC_MIN_B``, ``TC_MIN_GROUP``,
    ``TILE_ROWS``, ``RING``) set to ``over`` while inside: a sweep's
    forcing (the wrapper takes no such option)."""
    from rag_arc_tpu_torch.ops import ivf_scan as isc

    own = {name: getattr(isc, name) for name in over}
    for name, value in over.items():
        setattr(isc, name, value)
    try:
        yield
    finally:
        for name, value in own.items():
            setattr(isc, name, value)


def crossover(index, q_dev, label: str) -> list:
    """This tree's two scan paths on bf16 lists, each forced, by mean group
    size B·nprobe / nlist: device ms a call (the CSR plan and the query
    gather included) of the CUDA cores and of wgmma, and whether the two
    agree (the plain version's (B, Lmax, d) f32 gather would not fit the
    card at B=1024)."""
    from rag_arc_tpu_torch.ops import ivf_scan as isc

    rows = []
    for b, nprobe in CROSSOVER:
        q, probe = scan_operands(index, q_dev[:b], nprobe)
        args = (q, probe, index.lists, index.sqnorm, index.valid, "cosine")
        row = {"kernel": "ivf_scan_paths", "b": b, "nprobe": nprobe,
               "group": b * nprobe / index.nlist}
        outs = []
        for path, over in (("cores", float("inf")), ("wgmma", 0)):
            out = torch.empty((b, nprobe * index.lmax), device=q.device)
            outs.append(out)
            with scan_settings(TC_MIN_B=over, TC_MIN_GROUP=over):
                row[f"{path}_ms"] = queued_ms(lambda: isc.ivf_scan(*args, out=out))
        same_mask, err = scan_agrees(*outs)
        row["agree"] = same_mask and err <= SCAN_TOL
        print(json.dumps(row) + f"  [{label}]", flush=True)
        rows.append(row)
    return rows


def tile_sweep(index, q_dev, label: str) -> list:
    """The pair grid (B·nprobe < nlist) at each TILE_ROWS, rows staged
    through the ring or loaded straight: device ms a call, each held to the
    plain version; ``chosen`` marks the wrapper's own settings."""
    from rag_arc_tpu_torch.ops import ivf_scan as isc

    rows = []
    for b, nprobe in TILE_SWEEP:
        q, probe = scan_operands(index, q_dev[:b], nprobe)
        out = torch.empty((b, nprobe * index.lmax), device=q.device)
        args = (q, probe, index.lists, index.sqnorm, index.valid, "cosine")
        want = isc.ivf_scan_plain(*args)
        by_pair = isc.scan_schedule(b, nprobe, index.lists.shape[2], index.nlist, True)["by_pair"]
        for tile in TILE_ROWS:
            for ring in (False, True):
                with scan_settings(TILE_ROWS=tile, RING=ring):
                    isc.ivf_scan(*args, out=out)
                    same_mask, err = scan_agrees(out, want)
                    ms = queued_ms(lambda: isc.ivf_scan(*args, out=out))
                row = {"kernel": "ivf_scan_tiles", "b": b, "nprobe": nprobe,
                       "by_pair": by_pair, "tile_rows": tile, "ring": ring, "ms": ms,
                       "agree": same_mask and err <= SCAN_TOL,
                       "chosen": (isc.TILE_ROWS, isc.RING) == (tile, ring)}
                print(json.dumps(row) + f"  [{label}]", flush=True)
                rows.append(row)
    return rows


def search_kernels(index, q_dev, k: int, nprobe: int) -> dict:
    """The device kernels (name -> count) ``torch.profiler`` records in one
    ``search_sub`` of ``q_dev`` (after one untraced call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    index.search_sub(q_dev, k, nprobe)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        index.search_sub(q_dev, k, nprobe)
        torch.cuda.synchronize()
    names: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = short_name(e.name)
            names[name] = names.get(name, 0) + 1
    return names


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' lambdas and
    template arguments: ``at::native::reduce_kernel``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0), default=len(name))
    return name[:cut].strip()


def ivf_index(n: int, dev):
    from rag_arc_tpu_torch.index.ivf import DeviceIVFIndex
    from rag_arc_tpu_torch.tools import ivf_oracle as orc

    corpus, q, _ = orc.clustered_corpus(n, 768, 1024)
    index = DeviceIVFIndex.from_vectors(corpus, nlist=100, nprobe=8, dtype=torch.bfloat16,
                                        device=dev)
    return index, torch.from_numpy(q).to(dev)


def search_times(index, q_dev, label: str, reps: int = 20) -> None:
    """CUDA-event ms of one ``search_sub`` (k = 10) at B 1 / 8 / 32 and
    nprobe 8 / 32, mean of ``reps`` after one untimed call; and over 5
    calls back to back under ``torch.profiler``, the device's busy time a
    call (its kernels' durations summed) and the span from the first
    kernel's start to the last one's end, a call: busy / span is the
    device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for b in (1, 8, 32):
        for nprobe in (8, 32):
            fn = lambda: index.search_sub(q_dev[:b], 10, nprobe)  # noqa: E731
            fn()
            torch.cuda.synchronize()
            ms = cuda_ms(fn, reps)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
            ev = [e.time_range for e in prof.events() if e.device_type == DeviceType.CUDA]
            busy = sum(t.elapsed_us() for t in ev) / 5 / 1e3
            span = (max(t.end for t in ev) - min(t.start for t in ev)) / 5 / 1e3 if ev else 0.0
            print(json.dumps({"kind": "search_sub_ms", "b": b, "nprobe": nprobe, "ms": ms,
                              "busy_ms": busy, "span_ms": span}) + f"  [{label}]", flush=True)


def profile_lines(index, q_dev, label: str) -> dict:
    """The kernels one ``search_sub`` launches at (B, nprobe) (1, 8), (32, 8)
    and (32, 32): {"B x nprobe": count}, memcpy and memset apart."""
    out = {}
    for b, nprobe in ((1, 8), (32, 8), (32, 32)):
        names = search_kernels(index, q_dev[:b], 10, nprobe)
        n = sum(c for name, c in names.items() if not name.startswith("Mem"))
        out[f"{b}x{nprobe}"] = n
        print(json.dumps({"search_sub_kernels": {"b": b, "nprobe": nprobe, "kernels": n,
                                                 "memcpy_memset": sum(names.values()) - n,
                                                 "names": names}})
              + f"  [{label}]", flush=True)
    return out


@contextlib.contextmanager
def select_in_place(fn):
    """``ops/two_level.py``'s select (every flat search's) replaced by ``fn``."""
    from rag_arc_tpu_torch.ops import two_level as tl

    own = tl.iterative_argmax_resid
    tl.iterative_argmax_resid = fn
    try:
        yield
    finally:
        tl.iterative_argmax_resid = own


def selects(other: OtherKernels, splits=(1,)) -> dict:
    """name -> a select: the other's at each split its interface takes,
    then this tree's (so turns run other, this, this, other)."""
    from rag_arc_tpu_torch.ops import subtile_select as ss

    out = {}
    for s in splits if other.splits else (1,):
        out["other" if s == 1 else f"other_split{s}"] = \
            lambda x, k, s=s: other.iterative_argmax_resid(x, k, split=s)
    out["this"] = ss.iterative_argmax_resid
    return out


def ab_dense(other: OtherKernels, index, batches: list, label: str, k: int = 10,
             splits=(1,)) -> dict:
    """A flat index's search with each select of :func:`selects` in place,
    in turns: the first batch's search ms (CUDA events, mean of 10) and the
    sustained QPS of ``batches`` (dispatch all, then fetch all; host
    clock). ``equal``: every select's positions on the first batch equal
    this tree's."""
    from rag_arc_tpu_torch.index.flat import fetch_pair

    fns = selects(other, splits)
    q = batches[0]
    want = fetch_pair(*index.search_device(q, k))[1]
    equal = True
    for fn in fns.values():
        with select_in_place(fn):
            equal &= bool((fetch_pair(*index.search_device(q, k))[1] == want).all())

    def qps():
        t0 = time.perf_counter()
        outs = [index.search_device(b, k) for b in batches]
        for s, p in outs:
            fetch_pair(s, p)
        return q.shape[0] * len(batches) / (time.perf_counter() - t0)

    row = {"kind": "dense_search", "b": q.shape[0], "k": k, "equal": equal}
    for name in list(fns) + list(reversed(fns)):
        with select_in_place(fns[name]):
            index.search_device(q, k)
            torch.cuda.synchronize()
            row.setdefault(f"{name}_ms", []).append(
                cuda_ms(lambda: index.search_device(q, k), 10))
            row.setdefault(f"{name}_qps", []).append(qps())
    print(json.dumps(row) + f"  [{label}]", flush=True)
    return row


def ab_int8(other: OtherKernels, index, q_dev, label: str, k: int = 10,
            splits=(1,)) -> list:
    """An int8 flat index's search at B 1 / 8 / 32 with each select of
    :func:`selects` in place, in turns: ms a search (CUDA events, mean of
    20; the host's dispatch included, as a caller sees it)."""
    from rag_arc_tpu_torch.index.flat import fetch_pair

    fns = selects(other, splits)
    rows = []
    for b in (1, 8, 32):
        q = q_dev[:b]
        want = fetch_pair(*index.search_device(q, k))[1]
        row = {"kind": "int8_search", "b": b, "k": k, "equal": True}
        for name in list(fns) + list(reversed(fns)):
            with select_in_place(fns[name]):
                got = fetch_pair(*index.search_device(q, k))[1]
                row["equal"] &= bool((got == want).all())
                row.setdefault(f"{name}_ms", []).append(
                    cuda_ms(lambda: index.search_device(q, k), 20))
        print(json.dumps(row) + f"  [{label}]", flush=True)
        rows.append(row)
    return rows


def flat_index(n: int, dtype, dev, seed: int = 0):
    """A 2M x 768 flat index of unit rows made on the card, and 30 x 512
    unit queries near its rows."""
    from rag_arc_tpu_torch.index.flat import DeviceFlatIndex

    gen = torch.Generator(device=dev).manual_seed(seed)
    index = DeviceFlatIndex(dim=768, metric="cosine", capacity=n, dtype=dtype, device=dev)
    rows = []
    step = 1 << 17
    for start in range(0, n, step):
        part = unit_rows(gen, min(step, n - start), 768, dev)
        if start == 0:
            rows = part[torch.randint(0, part.shape[0], (30 * 512,), generator=gen,
                                      device=dev)]
        index.add(part.cpu().numpy())
    q = rows + 0.1 * torch.randn(rows.shape, generator=gen, device=dev)
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    return index, list(q.split(512))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="root of the other tree")
    ap.add_argument("--n", type=int, default=1_000_000, help="IVF corpus rows")
    ap.add_argument("--search", action="store_true",
                    help="only the kernel counts and search times of this tree's package")
    ap.add_argument("--dense", action="store_true",
                    help="the flat indexes' searches with the other tree's select in place")
    ap.add_argument("--select", action="store_true", help="only the select A/B")
    ap.add_argument("--other-split", default="1",
                    help="comma-separated splits of the other select (where it has them)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    dev = torch.device("cuda", 0)
    label = card()
    print(label, flush=True)
    if args.select:
        if not all(r["equal"] for r in ab_select(OtherKernels(args.parent), select_slab(dev),
                                                 label)):
            raise SystemExit("kernel_ab: the two selects disagree (see the rows above)")
        return
    if args.dense:
        other = OtherKernels(args.parent)
        splits = tuple(int(s) for s in args.other_split.split(","))
        index, batches = flat_index(2_000_000, torch.bfloat16, dev)
        rows = [ab_dense(other, index, batches, label, splits=splits)]
        del index
        torch.cuda.empty_cache()
        index, batches = flat_index(2_000_000, torch.int8, dev, seed=1)
        rows += ab_int8(other, index, batches[0], label, splits=splits)
        if not all(r["equal"] for r in rows):
            raise SystemExit("kernel_ab: a select changed a search's positions")
        return
    t0 = time.perf_counter()
    index, q_dev = ivf_index(args.n, dev)
    print(f"IVF built in {time.perf_counter() - t0:.1f} s, lmax {index.lmax}", flush=True)
    profile_lines(index, q_dev, label)
    if args.search:
        search_times(index, q_dev, label)
        return
    ok = all(r["agree"] for r in crossover(index, q_dev, label) + tile_sweep(index, q_dev, label))
    other = OtherKernels(args.parent)
    ok &= all(r["masks_equal"] and r["within_tol"] for r in ab_scan(other, index, q_dev, label))
    del index
    torch.cuda.empty_cache()
    ok &= all(r["equal"] for r in ab_select(other, select_slab(dev), label))
    if not ok:
        raise SystemExit("kernel_ab: two kernels disagree (see the rows above)")


if __name__ == "__main__":
    main()
