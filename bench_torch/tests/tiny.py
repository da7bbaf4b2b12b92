"""Tiny configurations and traffic for the CPU tests: the cells' shapes
of code at sizes a test run holds."""

from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

ENCODER = {"vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 2,
           "num_attention_heads": 4, "intermediate_size": 256,
           "max_position_embeddings": 512, "dtype": "float32", "param_dtype": "float32"}
RERANKER = {"vocab_size": 256, "hidden_size": 32, "intermediate_size": 64,
            "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
            "head_dim": 8, "max_position_embeddings": 1024, "rope_theta": 10000.0,
            "rms_norm_eps": 1e-6, "tie_word_embeddings": True, "dtype": "float32",
            "max_prompt_tokens": 512}


def spec() -> dict:
    """BENCHMARK.json with the two cells whose traffic files the harness
    keeps but the benchmark leaves out for their spread
    (``msmarco.batch64``, the closed loop; ``msmarco.chat``) added back,
    so that their paths stay tested."""
    s = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {w["name"] for w in s["workloads"]}
    for name, traffic in (("msmarco.batch64", "msmarco_batch64"), ("msmarco.chat", "msmarco_chat")):
        if name not in names:
            s["workloads"].append({"name": name, "config": "msmarco_e5base",
                                   "traffic": traffic, "chips": 1, "why": "left out"})
    e2e = {m["name"]: m for m in s["end_to_end"]}
    if "queries_per_s" not in e2e:
        s["end_to_end"].insert(0, {"name": "queries_per_s", "unit": "queries/s",
                                   "better": "higher", "bound": 0.25, "source": "host_clock",
                                   "workloads": ["msmarco.batch64"]})
    if "request_p95_ms" not in e2e:
        s["end_to_end"].insert(0, {"name": "request_p95_ms", "unit": "ms", "better": "lower",
                                   "bound": 0.25, "source": "host_clock", "workloads": []})
    for m in s["end_to_end"]:
        if m["name"] in ("request_p50_ms", "request_p95_ms") and "msmarco.chat" not in m["workloads"]:
            m["workloads"].append("msmarco.chat")
    return s


def config(name: str, rows: int = 3000) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["encoder"] = dict(ENCODER)
    cfg["corpus"] = dict(cfg["corpus"], rows=rows, dim=64, dtype="float32")
    cfg["corpus"]["passage_words"] = dict(cfg["corpus"]["passage_words"], cap=120)
    # float32 end to end: sound runs read ~1e-6, so the tiny limits are tight
    cfg["limits"] = {k: (0 if v == 0 else 1e-3) for k, v in cfg["limits"].items()}
    if cfg.get("reranker") is not None:
        cfg["reranker"] = dict(RERANKER)
        cfg["pipeline"] = dict(cfg["pipeline"], recall_k=20)
    return cfg


def traffic(name: str, **over) -> dict:
    tr = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    tr.update(over)
    return tr
