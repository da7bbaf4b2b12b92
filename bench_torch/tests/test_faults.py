"""A run with the timed path broken underneath comes out not correct.

Each test drives the whole of a run but the harness's look for a chip, on
the CPU at tiny sizes, once sound and once with one fault planted in the
built program: an answer altered where it is produced, half of a batch
left out (its rows answered with the other half's), content altered, a
step that leaves the state unchanged."""

import numpy as np
import pytest
import torch

from bench_torch import harness
from bench_torch.tests import tiny

CELLS = {
    "msmarco.batch64": ("msmarco_e5base", "msmarco_batch64",
                        dict(clients=4, bodies_per_client=8, queries_per_request=8,
                             check_requests=12)),
    "msmarco.chat": ("msmarco_e5base", "msmarco_chat", dict(rate_per_s=30.0, check_requests=24)),
    "nq_rerank.chat": ("nq_e5base_qwen3rr", "nq_chat", dict(rate_per_s=4.0, check_requests=4)),
    "msmarco.ingest": ("msmarco_e5base", "msmarco_ingest",
                       dict(batch_docs=32, pool_batches=16, warm_batches=1, check_docs=24)),
}


def _run(name, hook, tmp_path, seconds=2.5):
    cfg, tr, over = CELLS[name]
    return harness.run_cell(tiny.spec(), name, 2_900_000_017, seconds, False, device="cpu",
                            root=tmp_path, cfg=tiny.config(cfg), tr=tiny.traffic(tr, **over),
                            hook=hook, log=lambda m: None)


def answer_altered(sysm):
    index = sysm.store.index
    search = index.search_device

    def altered(q, k):
        s, p = search(q, k)
        return s, (p + 1) % index.size

    index.search_device = altered


def half_batch(sysm):
    index = sysm.store.index
    search = index.search_device

    def half(q, k):
        h = max(1, q.shape[0] // 2)
        s, p = search(q[:h], k)
        reps = -(-q.shape[0] // h)
        return s.repeat(reps, 1)[: q.shape[0]], p.repeat(reps, 1)[: q.shape[0]]

    index.search_device = half


def content_altered(sysm):
    docstore = sysm.store.docstore
    get = docstore.get_by_position

    def altered(pos):
        doc = get(pos)
        if doc is not None:
            doc = type(doc)(content=doc.content + " x", metadata=doc.metadata, id=doc.id)
        return doc

    docstore.get_by_position = altered
    docstore._doc_cache_cap = 0


def rerank_altered(sysm):
    rr = sysm.reranker
    score = rr._score_prompts

    def reversed_scores(prompts):
        return 1.0 - score(prompts)

    rr._score_prompts = reversed_scores


def state_unchanged(sysm):
    index = sysm.store.index
    add = index.add

    def add_keeping_rows(vectors):
        start, n = index.size, len(vectors)
        before = index.emb[start:start + n].clone()
        out = add(vectors)
        index.emb[start:start + n] = before
        return out

    index.add = add_keeping_rows


def ingest_half_batch(sysm):
    emb = sysm.emb
    encode = emb.encode

    def half(texts):
        h = max(1, len(texts) // 2)
        v = encode(texts[:h])
        return np.concatenate([v, v])[: len(texts)]

    emb.encode = half


@pytest.mark.parametrize("name", list(CELLS))
def test_sound_run_is_correct(name, tmp_path):
    out = _run(name, None, tmp_path)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("name,fault", [
    ("msmarco.batch64", answer_altered), ("msmarco.batch64", half_batch),
    ("msmarco.batch64", content_altered), ("msmarco.chat", answer_altered),
    ("nq_rerank.chat", rerank_altered), ("nq_rerank.chat", answer_altered),
    ("msmarco.ingest", state_unchanged), ("msmarco.ingest", ingest_half_batch),
])
def test_fault_is_caught(name, fault, tmp_path):
    out = _run(name, fault, tmp_path)
    assert not out["correct"], out["checks"]


def test_no_cuda_run_exits_nonzero_without_a_result(tmp_path):
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = subprocess.run([sys.executable, str(tiny.BENCH / "run.py"), "--workload",
                        "msmarco.chat", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120, cwd=tiny.ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
