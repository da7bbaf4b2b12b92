"""``rag_arc_tpu_torch/utils/transfers.py`` on CPU tensors: the behaviours
``tests/test_transfers.py`` holds the JAX ``TransferPool`` to (one flush
for many handles, late registration, unknown and single-claim handles,
the context manager's scope, concurrent demands sharing one flush, the
re-park on error), and streamed ``TorchVectorStore`` and multi-path
dispatches that flush once."""

import threading

import numpy as np
import pytest
import torch

from rag_arc_tpu_torch.utils import transfers
from rag_arc_tpu_torch.utils.transfers import TransferPool, current_pool, transfer_pool


@pytest.fixture()
def counting(monkeypatch):
    """Counts calls of ``device_get``, the one flush primitive."""
    calls = {"n": 0}
    real = transfers.device_get

    def counted(trees):
        calls["n"] += 1
        return real(trees)

    monkeypatch.setattr(transfers, "device_get", counted)
    return calls


def test_one_flush_for_many_handles(counting):
    pool = TransferPool()
    handles = [pool.register((torch.arange(3) + i, torch.ones(2) * i)) for i in range(5)]
    outs = [pool.result(h) for h in handles]
    assert counting["n"] == 1 and pool.flushes == 1  # the first demand flushed ALL
    for i, (a, b) in enumerate(outs):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        np.testing.assert_array_equal(a, np.arange(3) + i)
        np.testing.assert_array_equal(b, np.ones(2) * i)


def test_late_registration_triggers_second_flush(counting):
    pool = TransferPool()
    h0 = pool.register(torch.zeros(2))
    pool.result(h0)
    h1 = pool.register(torch.ones(2))
    np.testing.assert_array_equal(pool.result(h1), np.ones(2))
    assert counting["n"] == 2


def test_unknown_handle_raises():
    pool = TransferPool()
    with pytest.raises(KeyError):
        pool.result(99)


def test_result_is_single_claim(counting):
    pool = TransferPool()
    h = pool.register(torch.zeros(1))
    pool.result(h)
    with pytest.raises(KeyError):
        pool.result(h)


def test_context_manager_scoping():
    assert current_pool() is None
    with transfer_pool() as pool:
        assert current_pool() is pool
        h = pool.register(torch.arange(4))
    assert current_pool() is None
    # fetch closures capture the pool; results stay reachable after exit
    np.testing.assert_array_equal(pool.result(h), np.arange(4))


def test_concurrent_demands_share_one_flush(counting):
    pool = TransferPool()
    handles = [pool.register(torch.full((2,), i)) for i in range(8)]
    outs, errs = {}, []

    def claim(h):
        try:
            outs[h] = pool.result(h)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=claim, args=(h,)) for h in handles]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert not errs
    assert counting["n"] == 1
    for i, h in enumerate(handles):
        np.testing.assert_array_equal(outs[h], np.full(2, i))


def test_failed_flush_reparks_trees(monkeypatch):
    pool = TransferPool()
    handles = [pool.register(torch.full((2,), i)) for i in range(3)]
    real = transfers.device_get

    def broken(trees):
        raise RuntimeError("readback failed")

    monkeypatch.setattr(transfers, "device_get", broken)
    with pytest.raises(RuntimeError, match="readback failed"):
        pool.result(handles[0])
    monkeypatch.setattr(transfers, "device_get", real)
    # every tree is pending again: the next demand flushes them all
    assert [int(pool.result(h)[0]) for h in handles] == [0, 1, 2]
    assert pool.flushes == 1


def test_device_get_copies_cpu_tensors():
    t = torch.arange(5, dtype=torch.float32)
    tree = {"a": (t, [t * 2]), "b": 3}
    out = transfers.device_get(tree)
    t += 100  # a copy, not a view
    np.testing.assert_array_equal(out["a"][0], np.arange(5))
    np.testing.assert_array_equal(out["a"][1][0], 2 * np.arange(5))
    assert out["b"] == 3


def _store(texts):
    from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
    from rag_arc_tpu_torch.models.encoder import TransformerConfig
    from rag_arc_tpu_torch.models.torch_embeddings import TorchEncoderEmbeddings

    emb = TorchEncoderEmbeddings(TransformerConfig.tiny(dtype=torch.float32), device="cpu")
    return TorchVectorStore.from_texts(texts, emb, device="cpu")


@pytest.mark.parametrize("two_level", [False, True])
def test_streamed_store_dispatch_flushes_once(counting, two_level):
    """Chained encode → search dispatches of a stream under
    ``transfer_pool()`` read back in one flush, with the results the
    unpooled path gives."""
    texts = [f"topic {i % 7} document number {i}" for i in range(80)]
    store = _store(texts)
    store.index._force_two_level = two_level
    batches = [texts[:3], ["topic 3", "number 7 topic"], texts[40:45]]
    want = [store.dispatch_search_raw(b, k=5)() for b in batches]
    counting["n"] = 0
    with transfer_pool() as pool:
        fetches = [store.dispatch_search_raw(b, k=5) for b in batches]
    got = [f() for f in fetches]
    assert counting["n"] == 1 and pool.flushes == 1
    for (gs, gp), (ws, wp) in zip(got, want):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gs, ws)


def test_streamed_multipath_flushes_once(counting):
    """Dense + BM25 (hybrid, every query on the device) behind a
    shared-id-space MultiPathRetriever: dispatch every batch, prime, then
    fetch: one flush for the stream, and the sync path's documents."""
    from rag_arc_tpu_torch.retrieval.bm25 import BM25Retriever
    from rag_arc_tpu_torch.retrieval.multipath import MultiPathRetriever

    texts = [f"topic {i % 7} document number {i}" for i in range(80)]
    dense = _store(texts).as_retriever(search_kwargs={"k": 5})
    sparse = BM25Retriever.from_texts(texts, k=5, backend="hybrid", device="cpu")
    sparse.index.host_budget = 0
    multi = MultiPathRetriever([dense, sparse], top_k=3, shared_id_space=True)
    batches = [["topic 1 document", "document number 42"], ["topic 3", "number 7 topic"]]
    want = [multi.invoke_batch(b) for b in batches]
    counting["n"] = 0
    with transfer_pool() as pool:
        fetches = [multi.dispatch_batch(b) for b in batches]
        for f in fetches:
            f.prime()
    got = [f() for f in fetches]
    assert counting["n"] == 1 and pool.flushes == 1
    assert [[[d.id for d in r] for r in g] for g in got] == [
        [[d.id for d in r] for r in w] for w in want]
