"""The port's cross-encoder reranker against the JAX package's on the CPU:
the same prompts, the same ``HashTokenizer`` and the same weights (Flax
params through the weight bridges) must give the same order and scores
within 1e-5 (f32: summation order only), over both scorers — a tiny
Qwen3 through ``from_causal_lm`` and the tiny default ``CausalLM``. Also:
the ``CausalLM`` logits against Flax, scores that do not depend on batch
composition, ``rerank_batch`` equal to per-query ``rerank``, chunking, and
score stamping on copies. The packed path (a Qwen3 scorer): scores equal to
the bucketed path's on the same model, the packing's layout, its span
counts, and its fill on NQ-like lengths."""

import time

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


# -- the packed path (a scorer with last_logits_packed) -------------------------------


def _tiny_qwen3_reranker(attn_impl="auto", max_length=512, seed=0):
    cfg = tq.Qwen3Config.tiny(max_position_embeddings=512, attn_impl=attn_impl)
    model = tq.init_qwen3(cfg, seed, "cpu")
    tok = HashTokenizer(vocab_size=128, max_len=512)
    return tce.CrossEncoderReranker.from_causal_lm(model, None, tok, max_length=max_length)


def _bucketed_scores(rr, prompts):
    """The bucketed path's P(yes) on the same model: the left-padded rows
    through ``last_logits``."""
    ids, mask = rr._encode_bucketed(prompts)
    with torch.inference_mode():
        return tce._score_batch(rr.model, torch.from_numpy(ids), torch.from_numpy(mask),
                                rr.yes_id, rr.no_id).numpy()


def _long_docs(seed, n, words=(120, 220)):
    rng = np.random.default_rng(seed)
    return [Document(content=" ".join(f"w{int(x)}" for x in rng.integers(0, 500, int(m))),
                     id=f"long{i}") for i, m in enumerate(rng.integers(*words, n))]


@pytest.fixture
def prompt_span():
    """The rerank.prompts spans recorded while the test runs."""
    from rag_arc_tpu_torch.utils import tracing

    t0 = time.time_ns()
    tracing.enable()
    try:
        yield lambda: [s for s in tracing.spans(t0) if s.name == "rerank.prompts"]
    finally:
        tracing.disable()


@pytest.mark.parametrize("attn_impl", ["flash", "einsum"])
@pytest.mark.parametrize("case", ["short", "cut"])
def test_packed_scores_equal_the_bucketed_path(attn_impl, case, prompt_span):
    """Short prompts, 2-8 pairs a 512-token row; or, at max_length 192,
    long prompts cut to their tail beside short ones packed two or three
    a row: the packed P(yes) equals the bucketed path's on the same model
    and weights, pair by pair in the pairs' order."""
    max_length = 512 if case == "short" else 192
    rr = _tiny_qwen3_reranker(attn_impl, max_length)
    docs = _docs(10, 40) + (_long_docs(11, 6) if case == "cut" else [])
    docs = [docs[i] for i in np.random.default_rng(12).permutation(len(docs))]
    prompts = [rr._render("which doc answers the query", d.content) for d in docs]
    got = rr.compute_scores("which doc answers the query", docs)
    np.testing.assert_allclose(got, _bucketed_scores(rr, prompts), rtol=0, atol=1e-5)
    ids, mask = rr._encode_bucketed(prompts)
    rows, row_of, last = tce.pack_prompts(ids, mask, max_length)
    per_row = np.bincount(row_of)
    if case == "short":
        assert 2 <= per_row[:-1].min() and per_row.max() <= 8  # the last row takes the rest
    else:
        cut = mask.sum(axis=1) == max_length
        assert cut.sum() == 6 and per_row.max() >= 2
        for i in np.flatnonzero(cut):  # the tail kept, ending at the answer cue
            full = rr.tokenizer.encode(prompts[i], keep="tail")
            seg = rows[2, row_of[i]] == rows[2].reshape(-1)[last[i]]
            np.testing.assert_array_equal(rows[0, row_of[i]][seg], full[-max_length:])
    (span,) = prompt_span()
    assert span.attrs["path"] == "packed" and span.attrs["rows"] == rows.shape[1]
    assert span.attrs["slots"] == span.attrs["rows"] * max_length
    assert span.attrs["tokens"] == int(mask.sum()) and span.attrs["pairs"] == len(docs)


def test_pack_prompts_lays_each_pair_whole_in_one_row():
    """Each pair's real tokens sit in one row, in order, positions counted
    from 0; ``last`` points at its last token; padding only at row ends."""
    rr = _tiny_qwen3_reranker()
    prompts = [rr._render("q", d.content) for d in _docs(13, 30)]
    ids, mask = rr._encode_bucketed(prompts)
    rows, row_of, last = tce.pack_prompts(ids, mask, 512)
    p_ids, pos, seg = rows
    assert rows.dtype == np.int32 and p_ids.shape == (rows.shape[1], 512)
    for i, n in enumerate(mask.sum(axis=1)):
        r, c = divmod(int(last[i]), 512)
        assert r == row_of[i]
        np.testing.assert_array_equal(p_ids[r, c - n + 1 : c + 1], ids[i, -n:])
        np.testing.assert_array_equal(pos[r, c - n + 1 : c + 1], np.arange(n))
        assert (seg[r, c - n + 1 : c + 1] == seg[r, c]).all() and seg[r, c] >= 0
    live = seg >= 0
    # live tokens form a prefix of every row
    assert (np.diff(live.astype(np.int8), axis=1) <= 0).all()
    assert live.sum() == mask.sum()


def test_packed_chunks_give_the_same_scores():
    """Rows of 64 tokens, one pair a row: 70 rows, two 64-row chunks at
    the smallest budget; one readback in the pairs' order."""
    rr = _tiny_qwen3_reranker(max_length=64)
    docs = _docs(14, 70)
    want = rr.compute_scores("alpha", docs)
    rr.ATTN_BYTES_BUDGET = 1
    got = rr.compute_scores("alpha", docs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    prompts = [rr._render("alpha", d.content) for d in docs]
    np.testing.assert_allclose(got, _bucketed_scores(rr, prompts), rtol=0, atol=1e-5)


def test_packed_rerank_batch_matches_per_query(prompt_span):
    """Several queries' pairs share rows: each query's order and scores
    equal its own ``rerank``."""
    rr = _tiny_qwen3_reranker()
    queries = ["alpha beta", "delta query tpu", "rank", "answer"]
    cands = [_docs(15, 9), _docs(16, 3), [], _docs(17, 14)]
    got = rr.rerank_batch(queries, cands, k=4)
    (batch_span,) = prompt_span()
    assert batch_span.attrs["rows"] < batch_span.attrs["pairs"] == 26
    for q, docs, batched in zip(queries, cands, got):
        single = rr.rerank(q, docs, k=4)
        assert [d.id for d in single] == [d.id for d in batched]
        np.testing.assert_allclose([d.metadata["rerank_score"] for d in single],
                                   [d.metadata["rerank_score"] for d in batched],
                                   rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def qwen3_pair_packing():
    """The parity pair at max_length 512, where several prompts share a
    row on the port's side (the JAX package keeps its bucketed rows)."""
    cfg = fq.Qwen3Config.tiny(max_position_embeddings=512)
    fmodel = fq.FlaxQwen3LM(cfg)
    params = fmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32),
                         jnp.ones((1, 8), bool))
    params = jax.tree_util.tree_map(np.asarray, params)
    tok = HashTokenizer(vocab_size=128, max_len=512)
    jr = jce.CrossEncoderReranker.from_causal_lm(fmodel, params, tok, max_length=512)
    model = tq.Qwen3LM(tq.Qwen3Config.tiny(max_position_embeddings=512)).eval()
    tr = tce.CrossEncoderReranker.from_causal_lm(
        model, qwen3_state_dict_from_flax(params), tok, max_length=512)
    return jr, tr


def test_packed_scores_match_jax(qwen3_pair_packing, prompt_span):
    jr, tr = qwen3_pair_packing
    docs = _docs(18, 25) + _long_docs(19, 3, words=(100, 140))
    want = jr.compute_scores("which doc answers the query", docs)
    got = tr.compute_scores("which doc answers the query", docs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    (span,) = prompt_span()
    assert span.attrs["path"] == "packed" and span.attrs["rows"] < len(docs)
    queries = ["alpha beta", "delta query"]
    cands = [_docs(20, 11), _docs(21, 6)]
    t_out = tr.rerank_batch(queries, cands, k=5)
    j_out = jr.rerank_batch(queries, cands, k=5)
    assert [[d.id for d in r] for r in t_out] == [[d.id for d in r] for r in j_out]
    np.testing.assert_allclose(
        [d.metadata["rerank_score"] for r in t_out for d in r],
        [d.metadata["rerank_score"] for r in j_out for d in r], rtol=0, atol=1e-5)


def test_encode_bucketed_runs_once_a_pass_with_its_contract(prompt_span):
    """Through ``self`` once per scoring pass, as a wrapper on the instance
    sees it: left-padded rows of a bucket's width, the tail kept, each
    mask row summing to its pair's real token count."""
    rr = _tiny_qwen3_reranker(max_length=128)
    encode, seen = rr._encode_bucketed, []

    def recorded(prompts):
        ids, mask = encode(prompts)
        seen.append((list(prompts), ids, mask))
        return ids, mask

    rr._encode_bucketed = recorded
    docs = _docs(22, 5) + _long_docs(23, 2)
    rr.rerank_batch(["q one", "q two"], [docs[:4], docs[4:]], k=2)
    rr.rerank("q three", docs[:3], k=1)
    assert [len(p) for p, _, _ in seen] == [7, 3]
    prompts, ids, mask = seen[0]
    assert ids.shape == mask.shape and ids.shape[1] == 128
    assert (np.diff(mask.astype(np.int8), axis=1) >= 0).all()  # left-padded
    full = [rr.tokenizer.encode(p, keep="tail") for p in prompts]
    np.testing.assert_array_equal(mask.sum(axis=1), [min(len(f), 128) for f in full])
    for row, n, f in zip(ids, mask.sum(axis=1), full):
        np.testing.assert_array_equal(row[128 - n:], f[-n:])
    assert [s.attrs["pairs"] for s in prompt_span()] == [7, 3]


def test_causal_lm_scorer_keeps_the_bucketed_path(causal_pair, prompt_span):
    from rag_arc_tpu_torch.utils import tracing

    _, tr = causal_pair
    assert not hasattr(tr.model, "last_logits_packed")
    before = tracing.get_tracer().summary().get("rerank.prompts", {}).get("counts", {})
    tr.compute_scores("q", _docs(24, 6))
    (span,) = prompt_span()
    ids, _ = tr._encode_bucketed([tr._render("q", d.content) for d in _docs(24, 6)])
    assert span.attrs["path"] == "bucketed"
    assert (span.attrs["rows"], span.attrs["slots"]) == (6, ids.size)
    after = tracing.get_tracer().summary()["rerank.prompts"]["counts"]
    assert after["path=bucketed"] == before.get("path=bucketed", 0) + 1
    assert after.get("path=packed", 0) == before.get("path=packed", 0)


def test_packing_fills_nq_like_prompts():
    """NQ's length laws (query words lognormal mean 9.16, passage words
    78.88, sigma 0.3, caps 30 and 400) through the judge template: the
    buckets run about half their slots on padding, first-fit-decreasing
    into 512-token rows fills 85% or more."""
    rr = _tiny_qwen3_reranker()
    rng = np.random.default_rng(25)

    def words(mean, cap, n):
        x = rng.lognormal(np.log(mean) - 0.045, 0.3, n)
        return [" ".join(f"w{int(w)}" for w in rng.integers(0, 30000, int(m)))
                for m in np.clip(np.rint(x), 1, cap)]

    tokens = slots = bucket_slots = 0
    for query in words(9.16, 30, 8):
        prompts = [rr._render(query, p) for p in words(78.88, 400, 100)]
        ids, mask = rr._encode_bucketed(prompts)
        rows, _, _ = tce.pack_prompts(ids, mask, 512)
        tokens, slots, bucket_slots = (tokens + mask.sum(), slots + rows[0].size,
                                       bucket_slots + ids.size)
    assert tokens / slots >= 0.85
    assert tokens / bucket_slots < 0.7
