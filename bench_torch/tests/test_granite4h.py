"""The Granite 4.0-H cell's system (``systems/dense_rag_granite4h.py``)
driven whole on the CPU at a tiny size: a sound run is correct against the
plain f32 reference (its scan the token recurrence), and one whose scan
carries its state across the packed pairs' segment starts, or whose router
weighs its experts by normalized sigmoids in place of the softmax over the
top k, is not."""

import json

import pytest

from bench_torch import harness, roofline_granite4h
from bench_torch.tests import tiny

MODEL = {"vocab_size": 256, "hidden_size": 32, "intermediate_size": 16,
         "shared_intermediate_size": 24, "num_hidden_layers": 4, "num_attention_heads": 4,
         "num_key_value_heads": 2, "max_position_embeddings": 1024,
         "layer_types": ["mamba", "attention", "mamba", "mamba"], "mamba_n_heads": 16,
         "mamba_d_head": 4, "mamba_d_state": 8, "num_local_experts": 4,
         "num_experts_per_tok": 3, "attention_multiplier": 0.125,
         "expert_share": {"published_num_local_experts": 8, "cards": 2, "held": [0, 4]}}


def config() -> dict:
    """The cell's configuration with ``tiny``'s encoder, corpus and limits,
    the model cut to ``MODEL`` and computed in f32. Its matrices take std
    0.226, the gain that 0.02 gives at the published width 4,096 (0.02 ·
    sqrt(4096) ≈ 0.226 · sqrt(32)), so that each layer moves the logits
    here as it does there. The rerank limits are ``tiny``'s over 10: the
    logits come divided by 16 (``logits_scaling``), and sound f32 runs
    read ~2e-7 on them."""
    served = json.loads((tiny.BENCH / "configs" / "nq_e5base_granite4h.json").read_text())
    cfg = tiny.config("nq_e5base_granite4h")
    cfg.update(MODEL)
    cfg["reranker"] = dict(served["reranker"], dtype="float32", weight_std=0.226)
    for k in ("rerank_gap", "rerank_score_err", "rerank_err_mean"):
        cfg["limits"][k] = 1e-4
    return cfg


def _run(tmp_path):
    tr = tiny.traffic("nq_chat_granite4h", rate_per_s=4.0, check_requests=4)
    return harness.run_cell(tiny.spec(), "nq_granite4h.chat", 2_900_000_021, 2.5, False,
                            device="cpu", root=tmp_path, cfg=config(), tr=tr,
                            log=lambda m: None)


def test_sound_run_is_correct(tmp_path):
    out = _run(tmp_path)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["checks"]) >= {"retrieval_gap", "rerank_gap", "rerank_score_err",
                                  "rerank_err_mean"}


def scan_across_segments(granite_hybrid):
    """The scans carry their state across the packed pairs' segment starts."""
    from rag_arc_tpu_torch.ops import ssd_scan as ss

    return "ssd_scan", lambda xbc, dt, a, b, d, seg, **kw: ss.ssd_scan_plain(
        xbc, dt, a, b, d, (seg >= 0).to(seg.dtype) - 1, **kw)


def sigmoid_router(granite_hybrid):
    """The router weighs its chosen experts by normalized sigmoids (LFM2's)."""
    route = granite_hybrid.moe_route
    return "moe_route", lambda *a, **kw: route(*a, **dict(kw, scoring="sigmoid"))


@pytest.mark.parametrize("fault", [scan_across_segments, sigmoid_router])
def test_fault_is_caught(fault, tmp_path, monkeypatch):
    from rag_arc_tpu_torch.models import granite_hybrid

    monkeypatch.setattr(granite_hybrid, *fault(granite_hybrid))
    out = _run(tmp_path)
    assert not out["correct"], out["checks"]


def _served_rr_cfg() -> dict:
    from bench_torch.systems.dense_rag_granite4h import MODEL_KEYS

    cfg = json.loads((tiny.BENCH / "configs" / "nq_e5base_granite4h.json").read_text())
    share = cfg["expert_share"]
    return {**{k: cfg[k] for k in MODEL_KEYS}, **cfg["reranker"],
            "num_local_experts": share["published_num_local_experts"],
            "held_experts": tuple(share["held"])}


def test_published_counts():
    """granite-4.0-h-small's per-token FLOPs on this card by part (the
    Mamba projections 7.36 GFLOP of 13.01, the held experts' expected share
    3.77, the shared experts 1.51) and its parameters: 18.62B held here
    (13.59B in 36 of 72 experts a layer, 5.03B outside them), 32.21B whole."""
    cfg = _served_rr_cfg()
    parts = roofline_granite4h.token_flops(cfg)
    assert parts["mamba"] == pytest.approx(7.362e9, rel=1e-3)
    assert parts["experts"] == pytest.approx(3.775e9, rel=1e-3)
    assert parts["shared"] == pytest.approx(1.510e9, rel=1e-3)
    assert sum(parts.values()) == pytest.approx(13.01e9, rel=1e-3)
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    experts = 40 * roofline_granite4h.expert_weight_bytes(cfg) / 2
    w = roofline_granite4h.mamba_widths(cfg)
    mamba = 36 * (h * w["in_proj"] + w["conv"] * 5 + w["inner"] + 3 * w["heads"]
                  + w["inner"] * h)
    attn = 4 * (h * 6144 + h * h)
    outside = mamba + attn + 40 * (72 * h + 3 * h * 1536 + 2 * h) + h + v * h
    assert experts == pytest.approx(13.59e9, rel=1e-3)
    assert outside == pytest.approx(5.03e9, rel=1e-3)
    assert outside + 2 * experts == pytest.approx(32.21e9, rel=1e-3)


def test_the_weights_fill_the_served_module():
    """The seeded weights name every tensor of the module the system builds,
    at its shape, and only those."""
    import torch

    from bench_torch.systems.dense_rag_granite4h import granite_weights
    from rag_arc_tpu_torch.models.granite_hybrid import GraniteHybridLM, config_from_hf

    cfg = config()
    rr = {**{k: cfg[k] for k in ("vocab_size", "hidden_size", "intermediate_size",
                                 "shared_intermediate_size", "num_hidden_layers",
                                 "num_attention_heads", "num_key_value_heads",
                                 "max_position_embeddings", "rms_norm_eps", "layer_types",
                                 "mamba_n_heads", "mamba_d_head", "mamba_d_state",
                                 "mamba_n_groups", "mamba_d_conv", "mamba_expand",
                                 "mamba_conv_bias", "num_experts_per_tok",
                                 "embedding_multiplier", "attention_multiplier",
                                 "residual_multiplier", "logits_scaling",
                                 "tie_word_embeddings")},
          **cfg["reranker"], "num_local_experts": 8, "held_experts": (0, 4)}
    model = GraniteHybridLM(config_from_hf(rr, held=(0, 4)), device="meta")
    want = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    got = {k: tuple(t.shape) for k, t in granite_weights(rr, 5, "cpu", torch.float32)}
    assert got == want
