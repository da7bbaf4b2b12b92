"""The port's plain (CPU) path against the benchmark's references, at tiny
sizes in float32: they compute the same functions."""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_torch import data, weights
from bench_torch.reference import encoder as ref_encoder
from bench_torch.reference import fp8_mm
from bench_torch.reference import qwen3 as ref_qwen3
from bench_torch.reference import text as ref_text
from bench_torch.reference.topk import exact_topk
from bench_torch.systems.dense_rag import DenseRag
from bench_torch.tests import tiny

DEV = torch.device("cpu")


def _system(name="msmarco_e5base", rows=3000):
    return DenseRag(tiny.config(name, rows=rows), 7, DEV, Path("."), Path("."), torch)


def _texts(n, law, seed=1):
    rng = np.random.default_rng(seed)
    return data.random_texts(rng, data.draw_lengths(rng, n, law))


def test_encoder_matches_reference():
    sysm = _system()
    emb = sysm._embeddings()
    cfg = sysm.enc_cfg
    texts = _texts(40, {"mean": 30, "sigma": 0.8, "cap": 120})  # packed and bucketed
    got = torch.from_numpy(emb.encode(texts))
    w = weights.encoder_weights(cfg, 7, DEV)
    toks = [ref_text.tokens(t, cfg["vocab_size"], cfg["max_position_embeddings"]) for t in texts]
    want = ref_encoder.encode(w, toks, cfg, DEV)
    assert (got - want).abs().max() < 1e-5
    control = ref_encoder.encode(w, toks, cfg, DEV, mm=fp8_mm)
    assert (control - want).norm(dim=1).max() > 100 * (got - want).norm(dim=1).max()


def test_reranker_matches_reference():
    from rag_arc_tpu_torch.utils.data_model import Document

    sysm = _system("nq_e5base_qwen3rr")
    rr = sysm._reranker()
    rc = sysm.rr_cfg
    docs = _texts(12, {"mean": 60, "sigma": 0.5, "cap": 120}, seed=2)
    query = "what is the tallest mountain"
    probs = rr.compute_scores(query, [Document(content=d) for d in docs])
    got = np.log(probs / (1 - probs))
    yes, no = (ref_text.token_id(x, rc["vocab_size"]) for x in ("yes", "no"))
    toks = [ref_text.tokens(ref_text.rerank_prompt(query, d), rc["vocab_size"],
                            rc["max_prompt_tokens"], keep="tail") for d in docs]
    w = weights.qwen3_weights(rc, 7, DEV)
    want = ref_qwen3.yes_no_gap(w, toks, rc, yes, no, DEV).numpy()
    assert np.abs(got - want).max() < 1e-4
    control = ref_qwen3.yes_no_gap(w, toks, rc, yes, no, DEV, mm=fp8_mm).numpy()
    assert np.abs(control - want).max() > 100 * max(np.abs(got - want).max(), 1e-7)


@pytest.mark.parametrize("two_level", [False, True])
def test_index_matches_exact_topk(two_level):
    from rag_arc_tpu_torch.index.flat import DeviceFlatIndex

    corpus = dict(rows=5000, dim=64, dtype="float32", seed=11)
    index = DeviceFlatIndex(dim=64, capacity=5000, device=DEV)
    index._force_two_level = two_level
    for b in range(data.n_blocks(5000, data.VECTOR_BLOCK)):
        index.add(data.vector_block(torch, 11, b, 5000, 64, DEV).numpy())
    q = torch.randn(8, 64, generator=torch.Generator().manual_seed(3))
    q = q / q.norm(dim=1, keepdim=True)
    s, p = index.search(q.numpy(), 10)
    ref_s, ref_p, ex_s = exact_topk(q, 10, corpus, DEV, extra=p.tolist())
    assert (torch.from_numpy(p) == ref_p).all()
    assert (ex_s - ref_s).abs().max() < 1e-5
    assert math.isclose(float((ref_s - ex_s).max()), 0.0, abs_tol=1e-5)
