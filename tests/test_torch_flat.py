"""Parity of the port's DeviceFlatIndex with the JAX package's on the CPU:
the same adds, deletes and compactions, then searches through the direct
path, the two-level path (the JAX index on its certified stream path in
Pallas interpret mode, the port forced onto its two-level path), with
duplicated rows (tie order) and with fewer live rows than k (the -inf/-1
contract); l2 on the port's two-level path against the JAX index. Ids
must be equal and scores within 1e-5 (f32 sums in another order). Then
the rule that picks the path: the card's (bf16 two-level past 2^17 rows
or 2^22 scores, int8 always, f32 by the budget) and the CPU's (the JAX
package's budget)."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_arc_tpu.index.flat import DeviceFlatIndex as JaxFlat
from rag_arc_tpu_torch.index.flat import DeviceFlatIndex as TorchFlat, takes_two_level
from rag_arc_tpu_torch.utils import tracing

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(jax_path, torch_path, dtype="f32", capacity=4096, metric="cosine"):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    j = JaxFlat(dim=32, metric=metric, capacity=capacity, dtype=jdt)
    t = TorchFlat(dim=32, metric=metric, capacity=capacity, dtype=tdt, device="cpu")
    j._force_stream = jax_path == "two_level"
    t._force_two_level = torch_path == "two_level"
    return j, t


def _apply(idx, ops):
    for op, arg in ops:
        getattr(idx, op)(arg) if op != "compact" else idx.compact()


def _check(j, t, q, k):
    js, jp = j.search(q, k)
    ts, tp = t.search(q, k)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(ts, js, rtol=0, atol=ATOL)
    assert t.capacity == j.capacity and t.size == j.size
    assert t.n_active == j.n_active and t.n_deleted == j.n_deleted
    return ts, tp


def _corpus(seed, n, dups=True):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 32)).astype(np.float32)
    if dups:
        v[500:504] = v[17]      # exact duplicates: the tie order is checked
        v[2500] = v[33] * 2.0   # same direction (cosine tie)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    if dups:
        q[0], q[1] = v[17], v[33]
    return v, q


PATHS = [("direct", "direct"), ("two_level", "two_level"), ("direct", "two_level")]


@pytest.mark.parametrize("jax_path, torch_path", PATHS)
@pytest.mark.parametrize("metric", ["cosine", "ip"])
def test_add_delete_search(jax_path, torch_path, metric):
    v, q = _corpus(0, 3000)
    j, t = _pair(jax_path, torch_path, metric=metric)
    ops = [("add", v), ("mark_deleted", np.arange(100, 150)),
           ("mark_deleted", np.array([501, 120]))]  # 120 again: counted once
    _apply(j, ops)
    _apply(t, ops)
    ts, tp = _check(j, t, q, 10)
    assert tp[0, 0] == 17 and 501 not in tp


@pytest.mark.parametrize("jax_path, torch_path", PATHS)
def test_compact_then_grow(jax_path, torch_path):
    v, q = _corpus(1, 3000)
    j, t = _pair(jax_path, torch_path)
    ops = [("add", v), ("mark_deleted", np.arange(0, 2000, 3))]
    _apply(j, ops)
    _apply(t, ops)
    assert t.compact() == j.compact()
    more, _ = _corpus(2, 2500, dups=False)
    _apply(j, [("add", more)])   # past capacity 4096: both grow the same
    _apply(t, [("add", more)])
    assert t.capacity == j.capacity == 8192
    _check(j, t, q, 10)


@pytest.mark.parametrize("jax_path, torch_path", PATHS)
def test_fewer_live_rows_than_k(jax_path, torch_path):
    v, q = _corpus(3, 5, dups=False)
    j, t = _pair(jax_path, torch_path, capacity=2048)
    _apply(j, [("add", v)])
    _apply(t, [("add", v)])
    ts, tp = _check(j, t, q, 8)
    assert (tp[:, 5:] == -1).all() and np.isneginf(ts[:, 5:]).all()
    assert np.isfinite(ts[:, :5]).all()


def test_bf16_two_level_matches():
    v, q = _corpus(4, 3000)
    j, t = _pair("two_level", "two_level", dtype="bf16")
    ops = [("add", v), ("mark_deleted", np.arange(700, 760))]
    _apply(j, ops)
    _apply(t, ops)
    _check(j, t, q, 10)


def test_take_and_stats():
    v, _ = _corpus(5, 100, dups=False)
    j, t = _pair("direct", "direct")
    _apply(j, [("add", v), ("mark_deleted", np.array([3]))])
    _apply(t, [("add", v), ("mark_deleted", np.array([3]))])
    np.testing.assert_allclose(t.take(np.array([0, 3, 99])), j.take(np.array([0, 3, 99])),
                               rtol=0, atol=1e-7)
    assert not t.take(np.array([3])).any()  # deleted rows are zeroed
    st = t.stats()
    assert st["size"] == 100 and st["active"] == 99 and st["capacity"] == 4096


@pytest.mark.parametrize("kwargs, match", [(dict(mesh=object()), "sharded")])
def test_unported_options_raise(kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        TorchFlat(dim=32, device="cpu", **kwargs)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("torch_path", ["direct", "two_level"])
def test_l2_matches_jax(torch_path, dtype):
    # the JAX index answers l2 exactly on the CPU (its direct path); the
    # port's two-level l2 path must return the same ids
    v, q = _corpus(6, 3000)
    v[2500] = v[33] * 2.0  # under l2 a scaled copy is NOT a tie
    q[2] = v[2500]
    j, t = _pair("direct", torch_path, dtype=dtype, metric="l2")
    ops = [("add", v), ("mark_deleted", np.arange(100, 150))]
    _apply(j, ops)
    _apply(t, ops)
    np.testing.assert_array_equal(t.sqnorm.numpy(), np.asarray(j.sqnorm))
    ts, tp = _check(j, t, q, 10)
    assert tp[0, 0] == 17 and tp[2, 0] == 2500 and np.isfinite(ts).all()


def test_l2_compact_then_grow_two_level():
    v, q = _corpus(7, 3000)
    j, t = _pair("direct", "two_level", metric="l2")
    ops = [("add", v), ("mark_deleted", np.arange(0, 2000, 3))]
    _apply(j, ops)
    _apply(t, ops)
    assert t.compact() == j.compact()
    more, _ = _corpus(8, 2500, dups=False)
    _apply(j, [("add", more)])
    _apply(t, [("add", more)])
    _check(j, t, q, 10)


# -- the search path rule ----------------------------------------------------------

NQ_ROWS = 2_682_880  # the NQ index's capacity: the direct path's budget at B = 100
BF16, I8, F32 = torch.bfloat16, torch.int8, torch.float32


@pytest.mark.parametrize("device, dtype, b, capacity, two_level", [
    # a bf16 corpus on the card: the two-level kernels past 2^17 rows at
    # any B, or past 2^22 scores; the direct path within both
    ("cuda", BF16, 1, NQ_ROWS, True), ("cuda", BF16, 512, NQ_ROWS, True),
    ("cuda", BF16, 1, (1 << 17) + 1024, True), ("cuda", BF16, 1, 1 << 17, False),
    ("cuda", BF16, 32, 1 << 17, False), ("cuda", BF16, 33, 1 << 17, True),
    ("cuda", BF16, 64, 65_536, False), ("cuda", BF16, 128, 65_536, True),
    ("cuda", BF16, 1, 1024, False),
    # an int8 corpus on the card: always the kernels
    ("cuda", I8, 1, 1024, True), ("cuda", I8, 1, NQ_ROWS, True),
    # f32 keeps the budget rule on the card
    ("cuda", F32, 1, NQ_ROWS, False), ("cuda", F32, 100, NQ_ROWS, False),
    ("cuda", F32, 101, NQ_ROWS, True),
    # the CPU keeps the JAX package's rule for every dtype
    ("cpu", BF16, 1, NQ_ROWS, False), ("cpu", BF16, 100, NQ_ROWS, False),
    ("cpu", BF16, 101, NQ_ROWS, True), ("cpu", I8, 1, 4096, False),
    ("cpu", F32, 4096, 65_536, False), ("cpu", F32, 4097, 65_536, True),
])
def test_search_path_rule(device, dtype, b, capacity, two_level):
    assert takes_two_level(device, dtype, b, capacity) is two_level


def _search_paths(index, q, k):
    """The search's answer and the paths its ``index.search`` spans name."""
    t0 = time.time_ns()
    tracing.enable()
    try:
        out = index.search_device(q, k)
    finally:
        tracing.disable()
    return out, [s.attrs["path"] for s in tracing.spans(t0) if s.name == "index.search"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cpu_index_keeps_the_budget_rule(dtype):
    """On the CPU a B = 1 search takes the direct path and one whose score
    matrix exceeds the budget the two-level path, with the same ids (ip:
    under cosine the two paths round and normalize the query in different
    orders)."""
    v, q = _corpus(9, 3000, dups=False)
    _, t = _pair("direct", "direct", dtype=dtype, metric="ip")
    t.add(v)
    q = torch.from_numpy(q[:1])
    (s1, p1), paths = _search_paths(t, q, 10)
    assert paths == ["direct"]
    t.SCORE_BYTES_BUDGET = 4 * t.capacity - 1  # B = 1's score matrix now exceeds it
    (s2, p2), paths = _search_paths(t, q, 10)
    assert paths == ["two_level"]
    np.testing.assert_array_equal(p2.numpy(), p1.numpy())
    np.testing.assert_allclose(s2.numpy(), s1.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("dtype, two_level", [("bf16", True), ("f32", False)])
def test_index_on_a_card_takes_the_rule_of_its_dtype(dtype, two_level):
    """An index whose device is a CUDA card (its tensors left on the CPU,
    so the kernel wrappers take their plain versions) chooses its path
    by the card's rule: at a capacity past 2^17 rows bf16 takes the
    two-level path at B = 1, far within the CPU's budget, and f32 the
    direct path; the ids are the direct path's (ip, as above)."""
    v, q = _corpus(10, 3000, dups=False)
    _, t = _pair("direct", "direct", dtype=dtype, metric="ip", capacity=1 << 18)
    t.add(v)
    q = torch.from_numpy(q[:1])
    (s1, p1), paths = _search_paths(t, q, 10)
    assert paths == ["direct"]
    t.device = torch.device("cuda")
    (s2, p2), paths = _search_paths(t, q, 10)
    assert paths == ["two_level" if two_level else "direct"]
    np.testing.assert_array_equal(p2.numpy(), p1.numpy())
    np.testing.assert_allclose(s2.numpy(), s1.numpy(), rtol=0, atol=ATOL)
