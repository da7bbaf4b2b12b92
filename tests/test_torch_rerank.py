"""The port's cross-encoder reranker against the JAX package's on the CPU:
the same prompts, the same ``HashTokenizer`` and the same weights (Flax
params through the weight bridges) must give the same order and scores
within 1e-5 (f32: summation order only), over both scorers — a tiny
Qwen3 through ``from_causal_lm`` and the tiny default ``CausalLM``. Also:
the ``CausalLM`` logits against Flax, scores that do not depend on batch
composition, ``rerank_batch`` equal to per-query ``rerank``, chunking, and
score stamping on copies."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_arc_tpu.models import encoder as fenc
from rag_arc_tpu.models import qwen3 as fq
from rag_arc_tpu.models.tokenizer import HashTokenizer
from rag_arc_tpu.rerank import cross_encoder as jce
from rag_arc_tpu.utils.data_model import Document
from rag_arc_tpu_torch.models import encoder as tenc
from rag_arc_tpu_torch.models import qwen3 as tq
from rag_arc_tpu_torch.models.convert import (
    causal_lm_state_dict_from_flax,
    qwen3_state_dict_from_flax,
)
from rag_arc_tpu_torch.rerank import cross_encoder as tce


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _docs(seed, n):
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "query", "answer", "tpu", "rank", "doc"]
    return [
        Document(content=" ".join(rng.choice(words, int(rng.integers(1, 30)))),
                 metadata={"i": i}, id=f"d{i}")
        for i in range(n)
    ]


@pytest.fixture(scope="module")
def qwen3_pair():
    cfg = fq.Qwen3Config.tiny()
    fmodel = fq.FlaxQwen3LM(cfg)
    params = fmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                         jnp.ones((1, 8), bool))
    params = jax.tree_util.tree_map(np.asarray, params)
    tok = HashTokenizer(vocab_size=128, max_len=64)
    jr = jce.CrossEncoderReranker.from_causal_lm(fmodel, params, tok, max_length=64)
    model = tq.Qwen3LM(tq.Qwen3Config.tiny()).eval()
    tr = tce.CrossEncoderReranker.from_causal_lm(
        model, qwen3_state_dict_from_flax(params), tok, max_length=64)
    return jr, tr


@pytest.fixture(scope="module")
def causal_pair():
    fcfg = fenc.TransformerConfig.tiny(causal=True, dtype=jnp.float32)
    _, params = fenc.init_causal_lm(fcfg, seed=1)
    params = jax.tree_util.tree_map(np.asarray, params)
    jr = jce.CrossEncoderReranker(cfg=fcfg, params=params)
    tcfg = tenc.TransformerConfig.tiny(causal=True, dtype=torch.float32)
    tr = tce.CrossEncoderReranker(cfg=tcfg, params=causal_lm_state_dict_from_flax(params),
                                  device="cpu")
    return jr, tr


@pytest.fixture(params=["qwen3", "causal_lm"])
def pair(request, qwen3_pair, causal_pair):
    return qwen3_pair if request.param == "qwen3" else causal_pair


def test_scores_and_order_match_jax(pair):
    jr, tr = pair
    docs = _docs(0, 13)
    want = jr.compute_scores("which doc answers the query", docs)
    got = tr.compute_scores("which doc answers the query", docs)
    assert got.dtype == np.float32 and got.shape == (13,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    j_out = jr.rerank("which doc answers the query", docs, k=5)
    t_out = tr.rerank("which doc answers the query", docs, k=5)
    assert [d.id for d in t_out] == [d.id for d in j_out]
    np.testing.assert_allclose([d.metadata["rerank_score"] for d in t_out],
                               [d.metadata["rerank_score"] for d in j_out], rtol=0, atol=1e-5)


def test_rerank_batch_matches_jax_and_per_query(pair):
    jr, tr = pair
    queries = ["alpha beta", "delta query", "rank"]
    cands = [_docs(1, 7), _docs(2, 4), []]
    got = tr.rerank_batch(queries, cands, k=3)
    want = jr.rerank_batch(queries, cands, k=3)
    assert [[d.id for d in r] for r in got] == [[d.id for d in r] for r in want]
    for q, docs, batched in zip(queries, cands, got):
        single = tr.rerank(q, docs, k=3)
        assert [d.id for d in single] == [d.id for d in batched]
        np.testing.assert_allclose([d.metadata["rerank_score"] for d in single],
                                   [d.metadata["rerank_score"] for d in batched],
                                   rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="mismatch"):
        tr.rerank_batch(["a"], [])


def test_scores_do_not_depend_on_batch_composition(pair):
    """A pair scores the same alone (small bucket, little padding) as next
    to a long document (bigger bucket, heavy left padding) or in any
    order."""
    _, tr = pair
    short = Document(content="short relevant answer")
    long_doc = Document(content="filler words " * 40)
    alone = tr.compute_scores("the query", [short])[0]
    together = tr.compute_scores("the query", [long_doc, short])
    np.testing.assert_allclose(together[1], alone, rtol=0, atol=1e-5)
    docs = _docs(3, 9)
    scores = tr.compute_scores("q", docs)
    perm = np.random.default_rng(4).permutation(9)
    np.testing.assert_allclose(tr.compute_scores("q", [docs[i] for i in perm]),
                               scores[perm], rtol=0, atol=1e-5)


def test_chunks_give_the_same_scores(causal_pair):
    _, tr = causal_pair
    docs = _docs(5, 150)
    want = tr.compute_scores("alpha", docs)
    # 64-row chunks: three dispatches, one readback
    tr.ATTN_BYTES_BUDGET = 1
    try:
        got = tr.compute_scores("alpha", docs)
    finally:
        del tr.ATTN_BYTES_BUDGET
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_sorted_stamps_copies_in_stable_order(causal_pair):
    _, tr = causal_pair
    docs = _docs(6, 5)
    out = tr._sorted(docs, np.array([0.5, 0.9, 0.5, 0.1, 0.9], np.float32), 4)
    assert [d.id for d in out] == ["d1", "d4", "d0", "d2"]
    assert all("rerank_score" not in d.metadata for d in docs)
    assert out[0].metadata == {"i": 1, "rerank_score": pytest.approx(0.9)}
    assert out[0] is not docs[1]
    assert tr.rerank("q", []) == []
    pairs = tr.rerank_with_scores("q", docs, k=2)
    assert [s for _, s in pairs] == [d.metadata["rerank_score"] for d, _ in pairs]
    assert all(0.0 <= s <= 1.0 for _, s in pairs)


def test_causal_lm_matches_flax():
    fcfg = fenc.TransformerConfig.tiny(causal=True, dtype=jnp.float32)
    fmodel, params = fenc.init_causal_lm(fcfg, seed=2)
    params = jax.tree_util.tree_map(np.asarray, params)
    model = tenc.CausalLM(tenc.TransformerConfig.tiny(dtype=torch.float32))
    sd = causal_lm_state_dict_from_flax(params)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    rng = np.random.default_rng(7)
    ids = rng.integers(4, 512, (3, 20)).astype(np.int32)
    mask = np.arange(20)[None, :] >= np.array([0, 5, 19])[:, None]
    want = np.asarray(fmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    want_last = np.asarray(fmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask), True))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        got_last = model(torch.from_numpy(ids), torch.from_numpy(mask), True).numpy()
    np.testing.assert_allclose(got_last, want_last, rtol=0, atol=1e-5)
    # pad query rows: the same -1e9 bias on both sides, so all rows match
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_default_reranker_is_the_causal_768x12():
    """What the serving config builds: ``CrossEncoderReranker()`` over the
    default causal ``TransformerConfig``."""
    tr = tce.CrossEncoderReranker(device="cpu")
    cfg = tr.model.cfg
    assert isinstance(tr.model, tenc.CausalLM) and tr.device == torch.device("cpu")
    assert (cfg.dim, cfg.depth, cfg.heads, cfg.vocab_size, cfg.causal) == (
        768, 12, 12, 32768, True)
    out = tr.rerank_batch(["q one", "q two"], [_docs(8, 3), _docs(9, 2)], k=2)
    assert [len(r) for r in out] == [2, 2]
    scores = [d.metadata["rerank_score"] for r in out for d in r]
    assert all(0.0 <= s <= 1.0 for s in scores)


def test_from_causal_lm_checks_the_device():
    model = tq.Qwen3LM(tq.Qwen3Config.tiny())
    tok = HashTokenizer(vocab_size=128, max_len=64)
    assert tce.CrossEncoderReranker.from_causal_lm(model, None, tok).device.type == "cpu"
    with pytest.raises(ValueError, match="lives on"):
        tce.CrossEncoderReranker.from_causal_lm(model, None, tok, device="meta")


def test_prompt_is_the_jax_packages():
    assert tce.PROMPT_TEMPLATE == jce.PROMPT_TEMPLATE
    assert tce.DEFAULT_INSTRUCTION == jce.DEFAULT_INSTRUCTION
