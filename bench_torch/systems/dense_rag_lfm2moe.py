"""Dense RAG with the LFM2-MoE reranker: ``DenseRag``'s retrieve path (the
encoder, the exact bf16 cosine index, the blob docstore, ``RagPipeline``
and the HTTP app) and the port's ``Lfm2MoeLM`` (LFM2-8B-A1B) as the
cross-encoder over the recalled passages, on the packed rerank path.

The configuration file carries LFM2-8B-A1B's ``config.json`` keys at its
top level and the serving settings in its ``reranker`` block; the two
together are ``self.rr_cfg``. Weights come from the seed on the card:
matrices N(0, ``weight_std``), the conv taps N(0, ``conv_std``), the
expert bias N(0, ``expert_bias_std``), norm scales 1 + N(0, 0.02). The
check holds each kept answer's rerank logit to the plain f32 LFM2-MoE
reference (``bench_torch/reference/lfm2_moe.py``), as ``DenseRag`` holds
Qwen3's. The corpus, and so its cached docstore, is the Qwen3 cell's.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List

import torch

from bench_torch import data, roofline_lfm2moe
from bench_torch.reference import lfm2_moe as ref_lfm2_moe
from bench_torch.reference import text as ref_text
from bench_torch.systems.dense_rag import DenseRag, _dtype
from bench_torch.trace import wrap

# LFM2-8B-A1B's config.json keys the configuration file carries at its top level
MODEL_KEYS = (
    "vocab_size", "hidden_size", "intermediate_size", "moe_intermediate_size",
    "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
    "max_position_embeddings", "rope_theta", "norm_eps", "conv_L_cache", "conv_bias",
    "layer_types", "num_dense_layers", "num_experts", "num_experts_per_tok", "norm_topk_prob",
    "routed_scaling_factor", "use_expert_bias",
)
# the configuration whose cached docstore this one's corpus shares
DOCSTORE_OF = "nq_e5base_qwen3rr"


def lfm2moe_weights(cfg: dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The served module's state_dict from the seed, one tensor at a time
    (no f32 copy of the whole model is ever held)."""
    h, nh, nkv = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, e = h // nh, cfg["num_experts"]
    inter, moe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    std, conv_std = cfg["weight_std"], cfg["conv_std"]
    specs = [("embed_tokens.weight", (cfg["vocab_size"], h), std, 0.0)]
    for i, kind in enumerate(cfg["layer_types"]):
        p = f"layers.{i}."
        specs += [(p + "operator_norm.weight", (h,), 0.02, 1.0),
                  (p + "ffn_norm.weight", (h,), 0.02, 1.0)]
        if kind == "full_attention":
            specs += [(p + "self_attn.qkv_proj.weight", ((nh + 2 * nkv) * hd, h), std, 0.0),
                      (p + "self_attn.o_proj.weight", (h, nh * hd), std, 0.0),
                      (p + "self_attn.q_norm.weight", (hd,), 0.02, 1.0),
                      (p + "self_attn.k_norm.weight", (hd,), 0.02, 1.0)]
        else:
            specs += [(p + "conv.in_proj.weight", (3 * h, h), std, 0.0),
                      (p + "conv.weight", (h, cfg["conv_L_cache"]), conv_std, 0.0),
                      (p + "conv.out_proj.weight", (h, h), std, 0.0)]
        f = p + "feed_forward."
        if i < cfg["num_dense_layers"]:
            specs += [(f + "gateup_proj.weight", (2 * inter, h), std, 0.0),
                      (f + "down_proj.weight", (h, inter), std, 0.0)]
        else:
            specs += [(f + "gate.weight", (e, h), std, 0.0),
                      (f + "expert_bias", (e,), cfg["expert_bias_std"], 0.0),
                      (f + "gateup_proj", (e, 2 * moe, h), std, 0.0),
                      (f + "down_proj", (e, h, moe), std, 0.0)]
    specs += [("embedding_norm.weight", (h,), 0.02, 1.0)]
    if not cfg["tie_word_embeddings"]:
        specs += [("lm_head.weight", (cfg["vocab_size"], h), std, 0.0)]
    gen = torch.Generator(device=device).manual_seed(data.subseed(seed, 8))
    out = {}
    for name, shape, scale, shift in specs:
        t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        keep = torch.float32 if name.endswith("expert_bias") else dtype
        out[name] = (shift + scale * t).to(keep)
    return out


class DenseRagLfm2Moe(DenseRag):
    def __init__(self, cfg: dict, seed: int, device, cache_dir: Path, run_dir: Path, torch_mod):
        # a program without the model fails here, before any set-up
        from rag_arc_tpu_torch.models import lfm2_moe  # noqa: F401

        super().__init__(cfg, seed, device, cache_dir, run_dir, torch_mod)
        self.rr_cfg = {**{k: cfg[k] for k in MODEL_KEYS}, **cfg["reranker"]}

    def _docstore_dir(self) -> Path:
        own = self.cfg
        self.cfg = dict(own, name=DOCSTORE_OF)
        try:
            return super()._docstore_dir()
        finally:
            self.cfg = own

    def _weights(self):
        c = self.rr_cfg
        return lfm2moe_weights(c, self.seed, self.device, _dtype(self.torch, c["dtype"]))

    def _reranker(self):
        from rag_arc_tpu_torch.models.lfm2_moe import Lfm2MoeLM, config_from_hf
        from rag_arc_tpu_torch.models.tokenizer import HashTokenizer
        from rag_arc_tpu_torch.rerank.cross_encoder import CrossEncoderReranker

        c = self.rr_cfg
        dt = _dtype(self.torch, c["dtype"])
        mcfg = config_from_hf(c, dtype=dt, param_dtype=dt)
        model = Lfm2MoeLM(mcfg, device="meta").to_empty(device=self.device)
        model.load_state_dict(self._weights())
        model.eval()
        tok = HashTokenizer(vocab_size=mcfg.vocab_size, max_len=c["max_prompt_tokens"])
        return CrossEncoderReranker.from_causal_lm(model, None, tok, device=self.device)

    def _ref_rerank(self, qs, cand_rows, texts, mm) -> Dict[tuple, float]:
        """{(query index, position): yes-minus-no logit} of the reference."""
        rc = self.rr_cfg
        vocab = rc["vocab_size"]
        yes, no = ref_text.token_id("yes", vocab), ref_text.token_id("no", vocab)
        prompts, owner = [], []
        for i, row in enumerate(cand_rows):
            for x in row:
                prompts.append(ref_text.tokens(ref_text.rerank_prompt(qs[i], texts[x]), vocab,
                                               rc["max_prompt_tokens"], keep="tail"))
                owner.append((i, x))
        gaps = ref_lfm2_moe.yes_no_gap(self._weights(), prompts, rc, yes, no, self.device,
                                       mm=mm).tolist()
        self._ref_gaps = dict(zip(owner, gaps))
        return self._ref_gaps

    def evaluate_served(self, qs, positions, contents, probs, bad) -> Dict[str, float]:
        """``DenseRag``'s numbers, and ``rerank_err_mean``: the mean
        |logit(served P(yes)) - reference| over the served documents. A
        random-weight LFM2-MoE at these widths moves its yes/no logit by up
        to ~0.6 under bf16-sized noise on its input alone (a near-tie in a
        router flips an expert), so the largest error of ~1,600 pairs
        (``rerank_score_err``) has a wide tail in bf16 and in fp8 alike;
        the mean stays ~3.5 times apart between the two (``PERF.md``)."""
        self._ref_gaps = None
        out = super().evaluate_served(qs, positions, contents, probs, bad)
        if self._ref_gaps is None:
            return out
        errs = []
        for i in range(len(qs)):
            for x, prob in zip(positions[i], probs[i]):
                if x < 0:
                    continue
                if not 0.0 < prob < 1.0:
                    errs.append(math.inf)
                    continue
                errs.append(abs(math.log(prob / (1.0 - prob)) - self._ref_gaps[(i, x)]))
        out["rerank_err_mean"] = sum(errs) / len(errs) if errs else math.inf
        return out

    def instrument(self, spans, kind: str) -> None:
        """``DenseRag``'s ranges (the reranker, and the shared attention
        module's ``rope_prep`` / ``flash_attention`` in ``models/qwen3.py``),
        and one range each around the model's short convolutions, routing
        and expert GEMMs."""
        super().instrument(spans, kind)
        if kind == "ingest" or self.reranker is None:
            return
        from rag_arc_tpu_torch.models import lfm2_moe

        for fn in ("short_conv", "moe_route", "moe_experts"):
            wrap(lfm2_moe, fn, fn, spans, self.torch)

    def rerank_flops(self, pair_lengths: List[int]) -> float:
        return sum(roofline_lfm2moe.pair_flops(self.rr_cfg, int(n)) for n in pair_lengths)

    def attention_bound_s(self, pair_lengths: List[int]) -> float:
        return sum(roofline_lfm2moe.attention_bound_s(self.rr_cfg, int(n))
                   for n in pair_lengths)


SYSTEM = DenseRagLfm2Moe
