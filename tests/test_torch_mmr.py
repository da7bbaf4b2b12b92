"""Parity of the port's MMR search with the JAX package on the CPU.

``TorchVectorStore.max_marginal_relevance_search[_by_vector]`` against
``TPUVectorStore``'s on the same texts (hash embeddings, made from a
seed): ids equal at f32, bf16 and int8 storage, after deletes, on an
empty store, and the same refusal of ``lambda_mult`` out of [0, 1]. The
``mmr`` search type of the dense retriever answers through it, and the
host selection is the JAX package's ``mmr_select`` (numpy, copied)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_arc_tpu.index.vector_store import TPUVectorStore
from rag_arc_tpu.models.embeddings import HashEmbeddings as JaxHash
from rag_arc_tpu.ops.mmr import mmr_select as jax_mmr_select
from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
from rag_arc_tpu_torch.models.embeddings import HashEmbeddings
from rag_arc_tpu_torch.ops.mmr import mmr_select

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(60)]
    # near-duplicate clusters, so MMR's diversity term changes the order
    base = [" ".join(rng.choice(vocab, 6)) for _ in range(n // 4)]
    return [f"{base[i % len(base)]} {vocab[int(rng.integers(60))]}" for i in range(n)]


def _stores(dtype, n=80):
    jd, td = DTYPES[dtype]
    texts = _texts(n)
    ids = [f"d{i}" for i in range(n)]
    j = TPUVectorStore(JaxHash(dim=32), dtype=jd, capacity=1024)
    t = TorchVectorStore(HashEmbeddings(dim=32), dtype=td, capacity=1024, device="cpu")
    for store in (j, t):
        store.add_texts(texts, ids=ids)
        store.delete(["d2", "d9"])
    return j, t, texts


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lambda_mult", [0.0, 0.25, 0.5, 1.0])
def test_mmr_ids_match_jax(dtype, lambda_mult):
    j, t, texts = _stores(dtype)
    for q in texts[:6] + ["w1 w2 w3", "nothing like it"]:
        want = j.max_marginal_relevance_search(q, k=5, fetch_k=20, lambda_mult=lambda_mult)
        got = t.max_marginal_relevance_search(q, k=5, fetch_k=20, lambda_mult=lambda_mult)
        assert [d.id for d in got] == [d.id for d in want], q
        assert all(t.get_by_ids([d.id])[0] is d for d in got)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mmr_by_vector_matches_jax(dtype):
    j, t, _ = _stores(dtype)
    rng = np.random.default_rng(1)
    for _ in range(4):
        v = rng.standard_normal(32).astype(np.float32)
        want = j.max_marginal_relevance_search_by_vector(v, k=4, fetch_k=12)
        got = t.max_marginal_relevance_search_by_vector(v, k=4, fetch_k=12)
        assert [d.id for d in got] == [d.id for d in want]


def test_mmr_empty_store_and_short_candidates():
    j = TPUVectorStore(JaxHash(dim=16))
    t = TorchVectorStore(HashEmbeddings(dim=16), device="cpu")
    assert t.max_marginal_relevance_search("q") == j.max_marginal_relevance_search("q") == []
    for store in (j, t):
        store.add_texts(["a b", "c d", "e f"], ids=["a", "b", "c"])
    # fetch_k and k past the live rows: every row, once
    want = j.max_marginal_relevance_search("a b", k=10, fetch_k=50)
    got = t.max_marginal_relevance_search("a b", k=10, fetch_k=50)
    assert [d.id for d in got] == [d.id for d in want] and len(got) == 3


@pytest.mark.parametrize("lambda_mult", [-0.1, 1.5])
def test_mmr_lambda_out_of_range_raises_like_jax(lambda_mult):
    j, t, texts = _stores("float32", n=20)
    with pytest.raises(ValueError) as want:
        j.max_marginal_relevance_search(texts[0], lambda_mult=lambda_mult)
    with pytest.raises(ValueError) as got:
        t.max_marginal_relevance_search(texts[0], lambda_mult=lambda_mult)
    assert str(got.value) == str(want.value)


def test_mmr_select_copy_matches_jax():
    rng = np.random.default_rng(2)
    for n, k, lam in ((20, 5, 0.5), (7, 10, 0.0), (30, 30, 1.0), (0, 3, 0.5)):
        q = rng.standard_normal(16).astype(np.float32)
        cand = rng.standard_normal((n, 16)).astype(np.float32)
        assert mmr_select(q, cand, k, lam) == jax_mmr_select(q, cand, k, lam)


def test_mmr_retriever_search_type():
    j, t, texts = _stores("float32")
    kw = {"search_type": "mmr", "search_kwargs": {"k": 4, "fetch_k": 20}}
    jr, tr = j.as_retriever(**kw), t.as_retriever(**kw)
    for q in texts[:4]:
        assert [d.id for d in tr.invoke(q)] == [d.id for d in jr.invoke(q)]
    # the batched entry falls back to per-query MMR, as in the JAX package
    assert [[d.id for d in r] for r in tr.invoke_batch(texts[:3])] == [
        [d.id for d in r] for r in jr.invoke_batch(texts[:3])]
    # no async path for MMR: streaming callers fall back
    assert tr.dispatch_batch(texts[:2]) is None
