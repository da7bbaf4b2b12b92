"""Dense RAG with the Granite 4.0-H reranker: ``DenseRag``'s retrieve path
(the encoder, the exact bf16 cosine index, the blob docstore,
``RagPipeline`` and the HTTP app) and the port's ``GraniteHybridLM``
(granite-4.0-h-small, this card's share of its experts) as the
cross-encoder over the recalled passages, on the packed rerank path.

The configuration file carries granite-4.0-h-small's ``config.json`` keys
at its top level (``num_local_experts`` the experts this card holds), the
deployment in ``expert_share`` (the published expert count, which the
router keeps, and the range held here) and the serving settings in its
``reranker`` block; together they are ``self.rr_cfg``. Weights come from
the seed on the card, one tensor at a time, straight into the served
module (37 GB in bf16: a second copy would not fit beside it): matrices
N(0, ``weight_std``), the conv taps N(0, ``conv_std``) and bias N(0,
``conv_bias_std``), ``A`` uniform in [1, 16] (``A_log`` its log), ``dt``
log-uniform in [0.001, 0.1] (``dt_bias`` its inverse softplus), ``D`` 1,
norm scales 1 + N(0, ``norm_std``). The check holds each kept answer's
rerank logit to the plain f32 Granite reference
(``bench_torch/reference/granite_hybrid.py``, whose scan is the token
recurrence), with LFM2's numbers (``rerank_err_mean`` among them). The
corpus, and so its cached docstore, is the Qwen3 cell's.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import torch

from bench_torch import data, roofline_granite4h
from bench_torch.reference import granite_hybrid as ref_granite
from bench_torch.reference import text as ref_text
from bench_torch.systems.dense_rag import DenseRag, _dtype
from bench_torch.systems.dense_rag_lfm2moe import DenseRagLfm2Moe
from bench_torch.trace import wrap

# granite-4.0-h-small's config.json keys the model reads from the file's top level
MODEL_KEYS = (
    "vocab_size", "hidden_size", "intermediate_size", "shared_intermediate_size",
    "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
    "max_position_embeddings", "rms_norm_eps", "layer_types", "mamba_n_heads", "mamba_d_head",
    "mamba_d_state", "mamba_n_groups", "mamba_d_conv", "mamba_expand", "mamba_conv_bias",
    "mamba_proj_bias", "num_experts_per_tok", "embedding_multiplier", "attention_multiplier",
    "residual_multiplier", "logits_scaling", "position_embedding_type", "attention_bias",
    "tie_word_embeddings",
)
# the ops of the model's module that a traced run wraps in a range of their name
RANGED_OPS = ("mamba_conv", "ssd_scan", "gated_rms_norm", "moe_route", "moe_experts",
              "shared_expert")


def granite_weights(cfg: dict, seed: int, device,
                    dtype) -> Iterator[Tuple[str, torch.Tensor]]:
    """The served module's state_dict from the seed, one (name, tensor) at
    a time; ``A_log``, ``dt_bias`` and ``D`` in f32, the rest in ``dtype``."""
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = h // nh
    heads, n = cfg["mamba_n_heads"], cfg["mamba_d_state"]
    inner = heads * cfg["mamba_d_head"]
    conv = inner + 2 * n
    lo, hi = cfg["held_experts"]
    inter, shared = cfg["intermediate_size"], cfg["shared_intermediate_size"]
    std, norm_std = cfg["weight_std"], cfg["norm_std"]
    specs = [("embed_tokens.weight", (v, h), "normal", std, 0.0)]
    for i, kind in enumerate(cfg["layer_types"]):
        p = f"layers.{i}."
        specs += [(p + "input_layernorm.weight", (h,), "normal", norm_std, 1.0),
                  (p + "post_attention_layernorm.weight", (h,), "normal", norm_std, 1.0)]
        if kind == "attention":
            specs += [(p + "self_attn.qkv_proj.weight", ((nh + 2 * nkv) * hd, h), "normal", std,
                       0.0),
                      (p + "self_attn.o_proj.weight", (h, nh * hd), "normal", std, 0.0)]
        else:
            m = p + "mamba."
            specs += [(m + "in_proj.weight", (inner + conv + heads, h), "normal", std, 0.0),
                      (m + "conv1d.weight", (conv, cfg["mamba_d_conv"]), "normal",
                       cfg["conv_std"], 0.0),
                      (m + "conv1d.bias", (conv,), "normal", cfg["conv_bias_std"], 0.0),
                      (m + "dt_bias", (heads,), "dt_bias", 0.0, 0.0),
                      (m + "A_log", (heads,), "A_log", 0.0, 0.0),
                      (m + "D", (heads,), "normal", 0.0, 1.0),
                      (m + "norm.weight", (inner,), "normal", norm_std, 1.0),
                      (m + "out_proj.weight", (h, inner), "normal", std, 0.0)]
        f = p + "block_sparse_moe."
        specs += [(f + "router.weight", (cfg["num_local_experts"], h), "normal", std, 0.0),
                  (f + "gateup_proj", (hi - lo, 2 * inter, h), "normal", std, 0.0),
                  (f + "down_proj", (hi - lo, h, inter), "normal", std, 0.0),
                  (p + "shared_mlp.gateup_proj.weight", (2 * shared, h), "normal", std, 0.0),
                  (p + "shared_mlp.down_proj.weight", (h, shared), "normal", std, 0.0)]
    specs += [("norm.weight", (h,), "normal", norm_std, 1.0)]
    if not cfg["tie_word_embeddings"]:
        specs += [("lm_head.weight", (v, h), "normal", std, 0.0)]
    gen = torch.Generator(device=device).manual_seed(data.subseed(seed, 8))
    lo_dt, hi_dt = math.log(0.001), math.log(0.1)
    for name, shape, law, scale, shift in specs:
        if law == "A_log":
            yield name, torch.log(1.0 + 15.0 * torch.rand(shape, generator=gen, device=device))
        elif law == "dt_bias":
            u = torch.rand(shape, generator=gen, device=device)
            step = torch.exp(lo_dt + (hi_dt - lo_dt) * u)
            yield name, step + torch.log(-torch.expm1(-step))
        else:
            t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
            keep = torch.float32 if name.endswith(".D") else dtype
            yield name, (shift + scale * t).to(keep)


class DenseRagGranite4h(DenseRagLfm2Moe):
    """``DenseRagLfm2Moe``'s docstore sharing and its check (the reference
    logit of each served pair, and ``rerank_err_mean``), over Granite."""

    def __init__(self, cfg: dict, seed: int, device, cache_dir: Path, run_dir: Path, torch_mod):
        # a program without the model fails here, before any set-up
        from rag_arc_tpu_torch.models import granite_hybrid  # noqa: F401

        DenseRag.__init__(self, cfg, seed, device, cache_dir, run_dir, torch_mod)
        share = cfg["expert_share"]
        self.rr_cfg = {**{k: cfg[k] for k in MODEL_KEYS}, **cfg["reranker"],
                       "num_local_experts": share["published_num_local_experts"],
                       "held_experts": tuple(share["held"])}
        lo, hi = self.rr_cfg["held_experts"]
        if hi - lo != cfg["num_local_experts"]:
            raise ValueError(f"the file holds {cfg['num_local_experts']} experts, its share "
                             f"names {hi - lo}")

    def _weights(self) -> Iterator[Tuple[str, torch.Tensor]]:
        c = self.rr_cfg
        return granite_weights(c, self.seed, self.device, _dtype(self.torch, c["dtype"]))

    def _reranker(self):
        from rag_arc_tpu_torch.models.granite_hybrid import GraniteHybridLM, config_from_hf
        from rag_arc_tpu_torch.models.tokenizer import HashTokenizer
        from rag_arc_tpu_torch.rerank.cross_encoder import CrossEncoderReranker

        c = self.rr_cfg
        dt = _dtype(self.torch, c["dtype"])
        mcfg = config_from_hf(c, held=c["held_experts"], dtype=dt, param_dtype=dt)
        model = GraniteHybridLM(mcfg, device="meta").to_empty(device=self.device)
        state = model.state_dict()
        filled = set()
        with torch.no_grad():
            for name, t in self._weights():
                state[name].copy_(t)
                filled.add(name)
        if filled != set(state):
            raise RuntimeError(f"weights missing for {sorted(set(state) - filled)[:5]}")
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
        gaps = ref_granite.yes_no_gap(dict(self._weights()), prompts, rc, yes, no, self.device,
                                      mm=mm).tolist()
        self._ref_gaps = dict(zip(owner, gaps))
        return self._ref_gaps

    def instrument(self, spans, kind: str) -> None:
        """``DenseRag``'s ranges (the reranker), one range each around the
        model's new ops and its attention calls (``attn``), and one around
        each Mamba mixer whole, projections included (``mamba``)."""
        DenseRag.instrument(self, spans, kind)
        if kind == "ingest" or self.reranker is None:
            return
        from rag_arc_tpu_torch.models import granite_hybrid

        for fn in RANGED_OPS:
            wrap(granite_hybrid, fn, fn, spans, self.torch)
        wrap(granite_hybrid, "flash_attention", "attn", spans, self.torch)
        for layer in self.reranker.model.layers:
            if hasattr(layer, "mamba"):
                wrap(layer.mamba, "forward", "mamba", spans, self.torch)

    def rerank_flops(self, pair_lengths: List[int]) -> float:
        return sum(roofline_granite4h.pair_flops(self.rr_cfg, int(n)) for n in pair_lengths)

    def attention_bound_s(self, pair_lengths: List[int]) -> float:
        return sum(roofline_granite4h.attention_bound_s(self.rr_cfg, int(n))
                   for n in pair_lengths)


SYSTEM = DenseRagGranite4h
