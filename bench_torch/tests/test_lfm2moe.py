"""The LFM2-MoE cell's system (``systems/dense_rag_lfm2moe.py``) driven
whole on the CPU at a tiny size: a sound run is correct against the plain
f32 reference, and one whose short convolutions read across the packed
pairs' segment starts, or whose router leaves its weights unnormalized, is
not."""

import pytest

from bench_torch import harness, roofline_lfm2moe
from bench_torch.tests import tiny

MODEL = {"vocab_size": 256, "hidden_size": 32, "intermediate_size": 64,
         "moe_intermediate_size": 16, "num_hidden_layers": 6, "num_attention_heads": 4,
         "num_key_value_heads": 2, "max_position_embeddings": 1024,
         "layer_types": ["conv", "conv", "full_attention", "conv", "conv", "full_attention"],
         "num_dense_layers": 2, "num_experts": 8, "num_experts_per_tok": 2}


def config() -> dict:
    """The cell's configuration with ``tiny``'s encoder, corpus and limits,
    the model cut to ``MODEL`` and computed in f32. Its matrices take std
    0.15, the gain that 0.02 gives at the published width 2,048 (0.02 ·
    sqrt(2048) ≈ 0.15 · sqrt(32)), so that each layer moves the logits
    here as it does there."""
    import json

    served = json.loads((tiny.BENCH / "configs" / "nq_e5base_lfm2moe.json").read_text())
    cfg = tiny.config("nq_e5base_lfm2moe")
    cfg.update(MODEL)
    cfg["reranker"] = dict(served["reranker"], dtype="float32", weight_std=0.15)
    return cfg


def _run(tmp_path):
    tr = tiny.traffic("nq_chat_lfm2moe", rate_per_s=4.0, check_requests=4)
    return harness.run_cell(tiny.spec(), "nq_lfm2moe.chat", 2_900_000_021, 2.5, False,
                            device="cpu", root=tmp_path, cfg=config(), tr=tr, log=lambda m: None)


def test_sound_run_is_correct(tmp_path):
    out = _run(tmp_path)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["checks"]) >= {"retrieval_gap", "rerank_gap", "rerank_score_err"}


def conv_across_segments(lfm2_moe):
    """The short convolutions read across the packed pairs' segment starts."""
    from rag_arc_tpu_torch.ops import short_conv as sc

    return "short_conv", lambda bcx, w, seg: sc.short_conv_plain(
        bcx, w, (seg >= 0).to(seg.dtype) - 1)


def unnormalized_weights(lfm2_moe):
    """The router's top-k weights left as raw sigmoid scores."""
    route = lfm2_moe.moe_route
    return "moe_route", lambda *a, **kw: route(*a, **dict(kw, norm_topk_prob=False))


@pytest.mark.parametrize("fault", [conv_across_segments, unnormalized_weights])
def test_fault_is_caught(fault, tmp_path, monkeypatch):
    from rag_arc_tpu_torch.models import lfm2_moe

    monkeypatch.setattr(lfm2_moe, *fault(lfm2_moe))
    out = _run(tmp_path)
    assert not out["correct"], out["checks"]


def test_published_counts():
    """LFM2-8B-A1B's per-token FLOPs by part (experts
    1.94 of 2.85 GFLOP, the conv layers 0.60, the dense FFN 0.18, attention
    0.13) and its parameter count (8.34B)."""
    import json

    cfg = json.loads((tiny.BENCH / "configs" / "nq_e5base_lfm2moe.json").read_text())
    parts = roofline_lfm2moe.token_flops(cfg)
    assert parts["experts"] == pytest.approx(1.938e9, rel=1e-3)
    assert parts["conv"] == pytest.approx(0.604e9, rel=1e-3)
    assert parts["dense"] == pytest.approx(0.176e9, rel=1e-2)
    assert sum(parts.values()) == pytest.approx(2.85e9, rel=1e-2)
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    experts = 22 * roofline_lfm2moe.expert_weight_bytes(cfg) / 2
    conv = 18 * (4 * h * h + 3 * h)
    attn = 6 * (2 * h * h + 2 * h * 512 + 2 * 64)
    dense = 2 * 3 * h * cfg["intermediate_size"]
    routers = 22 * 32 * h
    norms = 49 * h
    assert experts + conv + attn + dense + routers + norms + v * h == pytest.approx(8.34e9,
                                                                                     rel=2e-3)
