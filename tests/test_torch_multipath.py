"""Fusion and multi-path retrieval on the CPU: the port's
``ops/fusion_kernel.py``, ``utils/fusion.py``, ``retrieval/multipath.py``
and ``TorchVectorStore.multi_query_search`` against the JAX package's.

The dense path is ``TorchVectorStore`` over ``TorchEncoderEmbeddings``
beside ``TPUVectorStore`` over ``FlaxEncoderEmbeddings`` on the same Flax
params (through ``models/convert.py``), f32; the sparse path a
``BM25Retriever`` over the same documents in both packages.

RRF over positions is bit-exact with the JAX function for one and two
paths, ties included. With three or more paths a document's f32 total
sums three or more contributions, and XLA's dot reassociates that sum:
there the scores agree within 1e-6 relative, and the ids wherever no
other candidate's score lies that close.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_arc_tpu.index.vector_store import TPUVectorStore
from rag_arc_tpu.models import encoder as fenc
from rag_arc_tpu.models.flax_embeddings import FlaxEncoderEmbeddings
from rag_arc_tpu.ops.fusion_kernel import rrf_fuse_positions as jrrf
from rag_arc_tpu.retrieval.bm25 import BM25Retriever as JBM25
from rag_arc_tpu.retrieval.multipath import MultiPathRetriever as JMulti
from rag_arc_tpu.utils import fusion as jfusion
from rag_arc_tpu.utils.data_model import Document as JDoc
from rag_arc_tpu.utils.data_model import RetrievalResult as JResult
from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
from rag_arc_tpu_torch.models import encoder as tenc
from rag_arc_tpu_torch.models.convert import encoder_state_dict_from_flax
from rag_arc_tpu_torch.models.torch_embeddings import TorchEncoderEmbeddings
from rag_arc_tpu_torch.ops.fusion_kernel import rrf_fuse_positions as trrf
from rag_arc_tpu_torch.retrieval.base import BaseRetriever as TBase
from rag_arc_tpu_torch.retrieval.bm25 import BM25Retriever as TBM25
from rag_arc_tpu_torch.retrieval.multipath import MultiPathRetriever as TMulti
from rag_arc_tpu_torch.utils import fusion as tfusion
from rag_arc_tpu_torch.utils.data_model import Document as TDoc
from rag_arc_tpu_torch.utils.data_model import RetrievalResult as TResult


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


SHAPES = [(4, 1, 10, 5), (4, 2, 10, 10), (4, 2, 10, 20), (3, 2, 5, 4), (4, 3, 8, 12),
          (4, 4, 6, 9)]  # (B, P, k, k_out): few shapes, so JAX compiles each once


def _positions(seed, shape):
    """(B, P, k) ranked candidate ids, unique per path, with empty slots
    and many cross-path duplicates (a small id space), so RRF totals tie."""
    rng = np.random.default_rng(seed)
    b, p, k, k_out = shape
    space = int(rng.integers(k, 3 * k + 2))
    pos = np.stack([np.stack([rng.permutation(space)[:k] for _ in range(p)]) for _ in range(b)])
    pos[rng.random(pos.shape) < 0.15] = -1
    return pos.astype(np.int32), k_out


def _fuse_both(pos, k_out):
    js, jp = (np.asarray(a) for a in jrrf(jnp.asarray(pos), k_out=k_out))
    ts, tp = trrf(torch.from_numpy(pos), k_out)
    return (ts.numpy(), tp.numpy()), (js, jp)


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[1] <= 2])
def test_rrf_positions_bit_exact_up_to_two_paths(shape):
    for seed in range(250):
        pos, k_out = _positions(seed, shape)
        (ts, tp), (js, jp) = _fuse_both(pos, k_out)
        np.testing.assert_array_equal(ts, js, err_msg=str(seed))
        np.testing.assert_array_equal(tp, jp, err_msg=str(seed))


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[1] > 2])
def test_rrf_positions_three_or_more_paths_within_reassociation(shape):
    for seed in range(150):
        pos, k_out = _positions(seed, shape)
        (ts, tp), (js, jp) = _fuse_both(pos, k_out)
        np.testing.assert_allclose(ts, js, rtol=1e-6, atol=0)
        for r in range(len(js)):
            for i in range(k_out):
                near = np.isclose(js[r], js[r, i], rtol=2e-6, atol=0).sum()
                if near == 1:
                    assert tp[r, i] == jp[r, i], (seed, r, i)


def test_rrf_positions_tie_order_is_first_occurrence():
    # path 0: [5, 7], path 1: [7, 5] -> both score 1/61 + 1/62; 5 came first
    pos = np.array([[[5, 7], [7, 5]]], np.int32)
    ts, tp = trrf(torch.from_numpy(pos), 3)
    assert tp.tolist() == [[5, 7, -1]] and ts[0, 0] == ts[0, 1] and torch.isneginf(ts[0, 2])


def _paths_np(seed, empty=0.1):
    rng = np.random.default_rng(seed)
    p = int(rng.integers(1, 4))
    return [np.where(rng.random((3, 8)) < empty, -1,
                     np.stack([rng.permutation(20)[:8] for _ in range(3)])) for _ in range(p)]


@pytest.mark.parametrize("seed", range(6))
def test_fusion_copy_unchanged(seed):
    paths = _paths_np(seed)
    got = tfusion.rrf_fuse_positions_np(paths, 6, rrf_k=60)
    want = jfusion.rrf_fuse_positions_np(paths, 6, rrf_k=60)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    paths = _paths_np(seed, empty=0.0)
    got = tfusion.rrf_fuse_positions_np(paths, 6, rrf_k=60)
    for fuser, doc, res in (
        (tfusion.RRFusion(k=60), TDoc, TResult),
        (jfusion.RRFusion(k=60), JDoc, JResult),
    ):
        lists = [[doc(content=f"c{int(x)}", id=f"c{int(x)}") for x in row if x >= 0]
                 for row in (p[0] for p in paths)]
        fused = fuser.fuse([[res(document=d, score=1.0, rank=r) for r, d in enumerate(ls, 1)]
                            for ls in lists], 6)
        ranked = fuser.fuse_ranked(lists, 6)
        out = [(d.content, d.metadata["fusion_score"]) for d in fused]
        assert out == [(d.content, d.metadata["fusion_score"]) for d in ranked]
        if doc is TDoc:
            t_out = out
    assert t_out == out
    # the shared-id-space fusion equals RRFusion over the same rows
    assert [c for c, _ in t_out] == [f"c{int(x)}" for x in got[1][0] if x >= 0]
    wsf = [f.fuse([[res(document=doc(content=c), score=s, rank=r)
                    for r, (c, s) in enumerate([("a", 3.0), ("b", 1.0)], 1)]], 2)
           for f, doc, res in ((tfusion.WeightedScoreFusion(), TDoc, TResult),
                               (jfusion.WeightedScoreFusion(), JDoc, JResult))]
    assert [d.metadata for d in wsf[0]] == [d.metadata for d in wsf[1]]


# -- multi-path over dense + BM25 ------------------------------------------------


def _texts(seed, n):
    rng = np.random.default_rng(seed)
    vocab = ["".join(rng.choice(list("abcdefghij"), int(rng.integers(3, 7)))) for _ in range(300)]
    lens = rng.integers(3, 30, n)
    return [" ".join(rng.choice(vocab, int(m))) for m in lens]


@pytest.fixture(scope="module")
def paths():
    fcfg = fenc.TransformerConfig.tiny(dtype=jnp.float32, max_len=64)
    tcfg = tenc.TransformerConfig.tiny(dtype=torch.float32, max_len=64)
    _, params = fenc.init_encoder(fcfg, seed=5)
    params = jax.tree_util.tree_map(np.asarray, params)
    texts = _texts(1, 150)
    ids = [f"d{i}" for i in range(len(texts))]
    jstore = TPUVectorStore(FlaxEncoderEmbeddings(fcfg, params=params), capacity=1024)
    jstore.add_texts(texts, ids=ids)
    temb = TorchEncoderEmbeddings(tcfg, state_dict=encoder_state_dict_from_flax(params),
                                  device="cpu")
    tstore = TorchVectorStore.from_texts(texts, temb, ids=ids, capacity=1024, device="cpu")
    docs = [JDoc(content=t, id=i) for t, i in zip(texts, ids)]
    jsparse = JBM25.from_documents(docs, k=5, backend="hybrid")
    tsparse = TBM25.from_documents([TDoc(content=t, id=i) for t, i in zip(texts, ids)],
                                   k=5, backend="hybrid", device="cpu")
    return jstore, tstore, jsparse, tsparse, texts


def _multis(paths, **kw):
    jstore, tstore, jsparse, tsparse, _ = paths
    j = JMulti([jstore.as_retriever(search_kwargs={"k": 8}), jsparse], **kw)
    t = TMulti([tstore.as_retriever(search_kwargs={"k": 8}), tsparse], **kw)
    return j, t


def _rows(out):
    return [[(d.id, d.metadata["fusion_score"]) for d in r] for r in out]


@pytest.mark.parametrize("shared", [True, False])
def test_multipath_matches_jax(paths, shared):
    j, t = _multis(paths, top_k=5, top_k_per_retriever=8, shared_id_space=shared)
    texts = paths[4]
    queries = texts[:6] + [" ".join(texts[7].split()[:3]), "nothing like the corpus"]
    got, want = t.invoke_batch(queries), j.invoke_batch(queries)
    assert [[i for i, _ in r] for r in _rows(got)] == [[i for i, _ in r] for r in _rows(want)]
    for g, w in zip(_rows(got), _rows(want)):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=1e-12)
    assert t._shared_ok is (True if shared else None)
    assert all(r[0].id == f"d{i}" for i, r in enumerate(got[:6]))
    # one query through invoke, and the async fan-out equal to the sync path
    assert [d.id for d in t.invoke(texts[3])] == [d.id for d in j.invoke(texts[3])]
    fetch = t.dispatch_batch(queries, k=5)
    fetch.prime()
    assert _rows(fetch()) == _rows(got)


def test_multipath_failure_isolation(paths):
    class Broken(TBase):
        position_space_size = 150

        def _get_relevant_documents(self, query, **kwargs):
            raise RuntimeError("path down")

        def dispatch_positions(self, queries, k):
            raise RuntimeError("positions down")

        def resolve_positions(self, rows):
            return [[None for _ in row] for row in rows]

    class FailsAtFetch(TBase):
        def _get_relevant_documents(self, query, **kwargs):
            return []

        def dispatch_batch(self, queries, **kwargs):
            def fetch():
                raise RuntimeError("fetch down")

            return fetch

    texts = paths[4]
    for shared in (True, False):
        j, t = _multis(paths, top_k=3, top_k_per_retriever=8, shared_id_space=shared)
        want = t.invoke_batch(texts[:3])
        t.add_retriever(Broken(name="broken"))
        t.add_retriever(FailsAtFetch(name="fetch-down"))
        if shared:
            t._shared_ok = None
            assert t._validate_shared() is False  # no position surface on one path
        assert _rows(t.invoke_batch(texts[:3])) == _rows(want)
        assert _rows(t.dispatch_batch(texts[:3])()) == _rows(want)
    # the broken path dispatched positions: fused without it
    _, t = _multis(paths, top_k=3, top_k_per_retriever=8, shared_id_space=True)
    want = t.invoke_batch(texts[:3])
    t.retrievers.append(Broken(name="broken"))
    t._shared_ok = True
    assert _rows(t.dispatch_batch(texts[:3])()) == _rows(want)


def test_misaligned_corpora_fall_back(paths, caplog):
    import logging

    _, tstore, _, _, texts = paths
    other = TBM25.from_texts([t + " extra" for t in texts[::-1]], k=5, device="cpu")
    mp = TMulti([tstore.as_retriever(search_kwargs={"k": 5}), other], top_k=3,
                shared_id_space=True)
    with caplog.at_level(logging.WARNING):
        out = mp.invoke_batch([texts[4]])
    assert mp._shared_ok is False and out[0]
    assert any("shared_id_space" in r.message for r in caplog.records)


def test_management_and_mutation(paths):
    _, t = _multis(paths, top_k=3)
    assert t.get_info()["retrievers"] == ["VectorStoreRetriever", "BM25Retriever"]
    assert t.remove_retriever("BM25Retriever") and not t.remove_retriever("BM25Retriever")
    t.set_fusion_method(tfusion.WeightedScoreFusion())
    assert t.get_info()["fusion"] == "WeightedScoreFusion"
    with pytest.raises(ValueError):
        TMulti([])
    texts = [f"filler document {i}" for i in range(12)]
    dense = TorchVectorStore.from_texts(texts, paths[1].embedding, device="cpu").as_retriever(
        search_kwargs={"k": 3})
    sparse = TBM25.from_texts(texts, device="cpu")
    mp = TMulti([dense, sparse], top_k=3)
    ids = mp.add_documents([TDoc(content="zanzibar spice markets")])
    assert any("zanzibar" in d.content for d in sparse.invoke("zanzibar spice"))
    assert any("zanzibar" in d.content for d in mp.invoke("zanzibar spice"))
    assert mp.delete(ids)
    assert not any("zanzibar" in d.content for d in mp.invoke("zanzibar spice"))
    assert TMulti([SyncOnly()], top_k=2).dispatch_batch(["q"]) is None


class SyncOnly(TBase):
    def _get_relevant_documents(self, query, **kwargs):
        return []


def test_multi_query_search_matches_jax(paths):
    jstore, tstore, _, _, texts = paths
    variants = [[texts[0], texts[1], " ".join(texts[2].split()[:2])], [texts[5]],
                [texts[9], texts[9]]]
    got = tstore.multi_query_search(variants, k=6, k_per_variant=5)
    want = jstore.multi_query_search(variants, k=6, k_per_variant=5)
    assert [[d.id for d, _ in r] for r in got] == [[d.id for d, _ in r] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=1e-6)
    assert tstore.multi_query_search([[]]) == [[]]
