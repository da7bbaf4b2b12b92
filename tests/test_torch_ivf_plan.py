"""The host-side plans of the IVF probe scan and the select kernels, and
the wrappers' launch counters, on the CPU.

- ``ops/ivf_scan.py::probe_plan_plain`` (the list → (b, p) inversion the
  scan kernel builds on the device) against a brute-force list of (list,
  b, p) triples: repeated lists, B = 1, B·nprobe past the prologue-scan
  limit, lists nobody probes; ``probe_plan`` on CPU tensors is it.
- ``scan_schedule``: one launch up to ``PROLOGUE_MAX`` pairs, the wgmma
  crossover by group size, the pair grid, the pass size and its shared
  memory for every d the wrapper takes.
- The scan's plain version on a probe where one list is probed by every
  query (the grouped case) against the JAX package's ``_ivf_search_body``.
- ``ops/_build.py::count_launch``: counts from many threads are exact.
- ``tools/kernel_ab.py``'s host-side helpers: the bound, the agreement
  checks and the scan's byte count.
"""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_arc_tpu.index.ivf import _ivf_search_body
from rag_arc_tpu_torch.ops import ivf_scan as isc
from rag_arc_tpu_torch.ops._build import count_launch
from rag_arc_tpu_torch.tools import kernel_ab as ab

H100_SMEM_BLOCK = 232_448  # the most shared memory one block may use (227 KB)


def _triples(probe: np.ndarray, nlist: int):
    """{list: sorted pair ids b·nprobe + p} by brute force."""
    b, nprobe = probe.shape
    out = {c: [] for c in range(nlist)}
    for i in range(b):
        for p in range(nprobe):
            out[int(probe[i, p])].append(i * nprobe + p)
    return out


@pytest.mark.parametrize("b,nprobe,nlist", [(1, 1, 4), (1, 8, 16), (5, 3, 3), (33, 12, 40),
                                            (300, 8, 100), (1100, 1, 7)])
def test_probe_plan_plain_matches_brute_force(b, nprobe, nlist):
    rng = np.random.default_rng(b * 7 + nprobe)
    # distinct lists a query, few lists in all: many repeats across queries
    probe = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(b)])
    offsets, pairs = isc.probe_plan_plain(torch.from_numpy(probe), nlist)
    assert offsets.dtype == torch.int32 and pairs.dtype == torch.int32
    assert offsets.shape == (nlist + 1,) and pairs.shape == (b * nprobe,)
    want = _triples(probe, nlist)
    for c in range(nlist):
        got = pairs[offsets[c]:offsets[c + 1]].tolist()
        assert got == want[c]  # id order within a list
    assert int(offsets[-1]) == b * nprobe
    cpu = isc.probe_plan(torch.from_numpy(probe), nlist)
    assert torch.equal(cpu[0], offsets) and torch.equal(cpu[1], pairs)


def test_probe_plan_one_list_probed_by_every_query():
    probe = np.zeros((1100, 1), dtype=np.int64)
    probe[::3, 0] = 2
    offsets, pairs = isc.probe_plan_plain(torch.from_numpy(probe), 5)
    assert offsets.tolist() == [0, 733, 733, 1100, 1100, 1100]
    assert pairs[733:].tolist() == list(range(0, 1100, 3))


@pytest.mark.parametrize("b,nprobe,csr", [(1, 1, False), (8, 32, False), (32, 32, False),
                                          (1, 1024, False), (1, 1025, True), (33, 32, True),
                                          (1134, 8, True)])
def test_scan_schedule_inverts_in_one_launch_up_to_the_prologue_limit(b, nprobe, csr):
    sched = isc.scan_schedule(b, nprobe, 768, 100)
    assert sched["csr"] is csr
    assert (b * nprobe > isc.PROLOGUE_MAX) is csr
    assert sched["by_pair"] is (b * nprobe < 100)  # fewer pairs than lists: a block a pair


@pytest.mark.parametrize("b,nprobe,nlist,tc_ok,tc", [
    (32, 8, 100, True, False),    # 2.56 queries a list: the CUDA cores
    (48, 8, 100, True, True),     # 3.84: wgmma
    (35, 10, 100, True, True),    # 3.5: the crossover itself
    (34, 10, 100, True, False),   # 3.4
    (32, 32, 100, True, True),
    (1024, 8, 100, True, True),
    (1024, 8, 100, False, False),  # f32 / int8 / unaligned lists: always the CUDA cores
    (8, 64, 100, True, False),    # B <= 8 keeps its one launch
    (8, 100, 100, True, False),
    (1, 100, 100, True, False)])
def test_scan_schedule_picks_wgmma_by_group_size(b, nprobe, nlist, tc_ok, tc):
    sched = isc.scan_schedule(b, nprobe, 768, nlist, tc_ok)
    assert sched["tc"] is tc
    assert (b * nprobe / nlist >= isc.TC_MIN_GROUP and b >= isc.TC_MIN_B and tc_ok) is tc
    if tc:
        assert sched["csr"] and not sched["by_pair"]  # the gathered queries follow the CSR
        assert sched["tc_qb"] == (64 if b * nprobe / nlist <= 64 else 128)
    else:
        assert sched["csr"] is (b * nprobe > isc.PROLOGUE_MAX)


@pytest.mark.parametrize("d,passes", [(96, 8), (100, 8), (768, 8), (1040, 7), (4096, 2),
                                      (12_288, 1)])
def test_scan_schedule_pass_fits_shared_memory(d, passes):
    sched = isc.scan_schedule(32, 8, d, 100)
    assert sched["passes"] == passes
    dq = -(-d // 4) * 4
    assert sched["smem"] == passes * dq * 4 <= isc.PASS_BYTES or passes == 1
    # the pass's queries beside the ring (72 KB at most) and the kernel's
    # static arrays (PROLOGUE_MAX pair ids, the tile's mask and norms, the
    # pass's pairs) within one block's limit
    assert sched["smem"] + 72 * 1024 + 4 * isc.PROLOGUE_MAX + 2048 <= H100_SMEM_BLOCK


@pytest.mark.parametrize("b", [1, 2, 4, 8, 12, 32, 64, 128, 1024, 4096])
@pytest.mark.parametrize("nprobe", [1, 8, 32])
@pytest.mark.parametrize("nlist", [100, 2000])
def test_scan_schedule_grid_by_shape(b, nprobe, nlist):
    """One grid row a (b, p) pair while pairs are fewer than lists (the
    CUDA cores only), else one a list; the CSR past PROLOGUE_MAX pairs and
    on wgmma; either grid's block count within the kernel's 32-bit grid
    with lists of a million rows in TILE_ROWS-row tiles."""
    for tc_ok in (False, True):
        sched = isc.scan_schedule(b, nprobe, 768, nlist, tc_ok)
        assert sched["tc"] is (tc_ok and b >= isc.TC_MIN_B
                               and b * nprobe / nlist >= isc.TC_MIN_GROUP)
        assert sched["by_pair"] is (not sched["tc"] and b * nprobe < nlist)
        assert sched["csr"] is (sched["tc"] or b * nprobe > isc.PROLOGUE_MAX)
        items = b * nprobe if sched["by_pair"] else nlist  # fewer than nlist either way
        assert -(-(1 << 20) // isc.TILE_ROWS) * items < 2**31
    assert 1 <= isc.TILE_ROWS <= 256  # csrc: ROWS, a thread a row


@pytest.mark.parametrize("dtype,metric", [("f32", "cosine"), ("bf16", "l2"), ("int8", "ip")])
def test_grouped_probe_scan_plain_matches_search_body(dtype, metric):
    """Every query probes list 0 and one other: one group of B queries."""
    rng = np.random.default_rng(3)
    nlist, lmax, d, b = 3, 9, 16, 40
    centroids = rng.standard_normal((nlist, d)).astype(np.float32)
    centroids[0] *= 4  # list 0 ranks first for (nearly) every query
    if dtype == "int8":
        lists = rng.integers(-127, 128, (nlist, lmax, d)).astype(np.int8)
        sqnorm = rng.uniform(0.001, 0.01, (nlist, lmax)).astype(np.float32)
        jdt, tdt = jnp.int8, torch.int8
    else:
        lists = rng.standard_normal((nlist, lmax, d)).astype(np.float32)
        if dtype == "bf16":
            lists = torch.from_numpy(lists).bfloat16().float().numpy()
        sqnorm = (lists * lists).sum(axis=2).astype(np.float32)
        jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else \
            (jnp.float32, torch.float32)
    valid = rng.random((nlist, lmax)) > 0.2
    pos = np.arange(nlist * lmax, dtype=np.int32).reshape(nlist, lmax)
    q = (centroids[0] + 0.5 * rng.standard_normal((b, d))).astype(np.float32)
    if metric == "cosine":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    nprobe = 2
    js, jp = _ivf_search_body(
        jnp.asarray(centroids), jnp.asarray(lists, jdt), jnp.asarray(sqnorm),
        jnp.asarray(valid), jnp.asarray(pos), jnp.ones(nlist, bool), jnp.asarray(q),
        nprobe * lmax, nprobe, metric)
    js, jp = np.asarray(js), np.asarray(jp)
    qt = torch.from_numpy(q)
    ct = torch.from_numpy(centroids)
    cross = qt @ ct.T
    c_scores = 2.0 * cross - (ct * ct).sum(1) if metric == "l2" else cross
    probe = torch.sort(c_scores, dim=1, descending=True, stable=True)[1][:, :nprobe]
    offsets, _ = isc.probe_plan_plain(probe, nlist)
    assert int(offsets[1] - offsets[0]) >= b - 2  # list 0's group: (nearly) every query
    got = isc.ivf_scan_plain(qt, probe, torch.from_numpy(lists).to(tdt),
                             torch.from_numpy(sqnorm), torch.from_numpy(valid), metric,
                             cross if dtype == "int8" else None).numpy()
    got_pos = pos[probe.numpy()].reshape(b, -1)
    for r in range(b):
        fin = np.isfinite(js[r])
        want = dict(zip(jp[r][fin].tolist(), js[r][fin].tolist()))
        mine = {int(p): float(s) for p, s in zip(got_pos[r], got[r]) if np.isfinite(s)}
        assert mine.keys() == want.keys()
        # f32 sums of 16 products in another order; l2 scores reach ~600
        np.testing.assert_allclose([mine[p] for p in want], list(want.values()), rtol=1e-6,
                                   atol=1e-4)


def test_count_launch_is_exact_under_threads():
    name = isc.__name__
    saved, interval = isc.launches, sys.getswitchinterval()
    isc.launches = 0
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        threads = [threading.Thread(target=lambda: [count_launch(name) for _ in range(5000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert isc.launches == 8 * 5000
    finally:
        sys.setswitchinterval(interval)
        isc.launches = saved


def test_count_launch_keeps_each_counter_apart():
    saved = (isc.launches, isc.launches_plan)
    try:
        isc.launches = isc.launches_plan = 0
        count_launch(isc.__name__)
        count_launch(isc.__name__, "launches_plan")
        count_launch(isc.__name__, "launches_plan")
        assert (isc.launches, isc.launches_plan) == (1, 2)
    finally:
        isc.launches, isc.launches_plan = saved


def test_bound_takes_the_larger_of_operations_and_bytes():
    assert ab.bound(989e12, ab.H100_BF16_PEAK, 1e6) == {"bound_ms": 1e3, "bound_by": "operations"}
    got = ab.bound(1.0, ab.H100_BF16_PEAK, 3.35e9)
    assert got["bound_by"] == "bytes" and got["bound_ms"] == pytest.approx(1.0)


def test_same_select_compares_live_picks_only():
    picked = torch.tensor([[3, 1, 7]])
    live = torch.tensor([[True, True, False]])
    resid = torch.tensor([0.5])
    assert ab.same_select((picked, live, resid), (torch.tensor([[3, 1, 9]]), live, resid))
    assert not ab.same_select((picked, live, resid), (torch.tensor([[1, 3, 7]]), live, resid))
    assert not ab.same_select((picked, live, resid), (picked, live, torch.tensor([0.25])))


@pytest.mark.parametrize("delta,masks,within", [(0.0, True, True), (5e-6, True, True),
                                                (2e-5, True, False)])
def test_scan_agrees_checks_masks_and_tolerance(delta, masks, within):
    want = torch.tensor([[0.5, float("-inf"), -0.25]])
    got = want + torch.tensor([[delta, 0.0, 0.0]])
    same_mask, err = ab.scan_agrees(got, want)
    assert same_mask is masks and (err <= ab.SCAN_TOL) is within
    moved = torch.tensor([[float("-inf"), 0.5, -0.25]])
    assert not ab.scan_agrees(moved, want)[0]


def test_scan_bound_reads_each_distinct_list_once():
    class Index:  # what scan_bound reads of a DeviceIVFIndex
        lmax = 5
        lists = torch.zeros((4, 5, 8), dtype=torch.bfloat16)
        valid = torch.tensor([[1, 1, 0, 0, 0], [1, 1, 1, 1, 1], [0] * 5, [1, 0, 0, 0, 0]],
                             dtype=torch.bool)

    probe = torch.tensor([[1, 3], [1, 0], [3, 1]])
    ops, nbytes, distinct = ab.scan_bound(Index, probe, 3)
    assert distinct == 3  # lists 0, 1, 3; list 1 probed three times, read once
    live = 2 + 5 + 1
    assert nbytes == live * (8 * 2 + 4) + 3 * 5 + 3 * 2 * 5 * 4 + 3 * 8 * 4
    assert ops == 2.0 * 3 * 2 * 5 * 8


@pytest.mark.parametrize("name,short", [
    ("void (anonymous namespace)::ivf_scan_kernel<1, 0, 2>(float const*, long)",
     "ivf_scan_kernel"),
    ("void at::native::reduce_kernel<512, 1>(at::native::ReduceOp)", "at::native::reduce_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
])
def test_short_name_strips_templates_and_arguments(name, short):
    assert ab.short_name(name) == short
