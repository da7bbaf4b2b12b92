"""The port's LFM2-MoE model (``models/lfm2_moe.py``) and its new ops
(``ops/short_conv.py``, ``ops/moe.py``) on the CPU at a tiny size, against
the benchmark's plain f32 reference (``bench_torch/reference/lfm2_moe.py``)
and, with every layer dense, against HF transformers' ``Lfm2ForCausalLM``.
The tiny model has the layer pattern conv, conv, attention, conv, conv,
attention, two dense layers, 8 experts, top 2 and a non-zero seeded
expert bias.

The cases marked ``gpu`` need a CUDA card (a Triton kernel has no CPU
mode, and ``torch._grouped_mm`` runs its card kernel only there) and skip
here; on a machine with a card run

    python -m pytest tests/test_torch_lfm2_moe.py --noconftest -m gpu -q

(this file imports no JAX).
"""

import dataclasses

import numpy as np
import pytest
import torch

from bench_torch.reference import lfm2_moe as ref
from rag_arc_tpu_torch.models import lfm2_moe
from rag_arc_tpu_torch.models.convert import lfm2_moe_state_dict_from_hf
from rag_arc_tpu_torch.models.lfm2_moe import Lfm2MoeConfig, Lfm2MoeLM, init_lfm2_moe
from rag_arc_tpu_torch.models.tokenizer import HashTokenizer
from rag_arc_tpu_torch.ops import moe as moe_ops
from rag_arc_tpu_torch.ops import short_conv as sc
from rag_arc_tpu_torch.rerank.cross_encoder import CrossEncoderReranker, _p_yes, pack_prompts
from rag_arc_tpu_torch.utils import tracing
from rag_arc_tpu_torch.utils.data_model import Document

# f32 on both sides; the two sum in other orders (einsum against matmul,
# index_add against a gather and sum), ~1e-7 apart on logits of ~0.5-5
F32_TOL = 1e-4


def _cfg_dict(cfg: Lfm2MoeConfig) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _model(seed=0, **kw):
    """The tiny model, its weights scaled up from N(0, 0.02) so that every
    layer moves the logits (and ties in the router are rare)."""
    model = init_lfm2_moe(Lfm2MoeConfig.tiny(**kw), seed=seed, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.endswith("norm.weight"):
                p.mul_(10.0)
    return model


def _left_padded(token_lists):
    length = max(len(t) for t in token_lists)
    ids = torch.zeros((len(token_lists), length), dtype=torch.long)
    mask = torch.zeros((len(token_lists), length), dtype=torch.bool)
    for i, t in enumerate(token_lists):
        ids[i, length - len(t):] = torch.tensor(t)
        mask[i, length - len(t):] = True
    return ids, mask


def _tokens(rng, lengths, vocab=128):
    return [[int(x) for x in rng.integers(4, vocab, size=n)] for n in lengths]


@pytest.mark.parametrize("attn_impl", ["auto", "einsum"])
def test_last_logits_match_reference(attn_impl):
    model = _model(attn_impl=attn_impl)
    toks = _tokens(np.random.default_rng(1), (1, 2, 5, 17, 30, 9))
    ids, mask = _left_padded(toks)
    want = ref.last_logits(model.state_dict(), toks, _cfg_dict(model.cfg), "cpu")
    with torch.no_grad():
        got = model.last_logits(ids, mask)
        rows, _, last = pack_prompts(ids.numpy(), mask.numpy(), 48)
        r = torch.from_numpy(rows)
        packed = model.last_logits_packed(r[0], r[1], r[2], torch.from_numpy(last))
    assert want.abs().max() > 0.5
    torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL)
    torch.testing.assert_close(packed, want, rtol=0, atol=F32_TOL)


def _crossing_conv(bcx, weight, seg):
    """A conv that reads across segment starts (padding still masked)."""
    return sc.short_conv_plain(bcx, weight, torch.where(seg >= 0, 0, -1).to(seg.dtype))


@pytest.mark.parametrize("start", [0, 1, 2])
def test_packed_pair_equals_pair_alone(start, monkeypatch):
    """A pair whose segment starts at column 0, 1 or 2 of its row, with a
    filler segment before it and another pair after it, reads as each run
    alone; a conv that crosses segment starts fails the same check."""
    model = _model()
    rng = np.random.default_rng(start)
    filler, pair, after = _tokens(rng, (start, 11, 7))
    row = filler + pair + after
    length = 32
    ids = torch.zeros((1, length), dtype=torch.long)
    pos = torch.zeros((1, length), dtype=torch.long)
    seg = torch.full((1, length), -1, dtype=torch.int32)
    col, spans = 0, []
    for s, toks in enumerate(x for x in (filler, pair, after) if x):
        ids[0, col:col + len(toks)] = torch.tensor(toks)
        pos[0, col:col + len(toks)] = torch.arange(len(toks))
        seg[0, col:col + len(toks)] = s
        col += len(toks)
        spans.append(col - 1)
    assert col == len(row)
    alone = [t for t in (filler, pair, after) if t]
    with torch.no_grad():
        want = torch.cat([model.last_logits(*_left_padded([t])) for t in alone])
        got = model.last_logits_packed(ids, pos, seg, torch.tensor(spans))
        torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL)
        monkeypatch.setattr(lfm2_moe, "short_conv", _crossing_conv)
        crossed = model.last_logits_packed(ids, pos, seg, torch.tensor(spans))
    assert (crossed[-1] - want[-1]).abs().max() > 100 * F32_TOL
    if start:
        assert (crossed[-2] - want[-2]).abs().max() > 100 * F32_TOL


def test_short_conv_stops_at_segments_and_padding():
    rng = np.random.default_rng(3)
    h, k = 4, 3
    bcx = torch.from_numpy(rng.standard_normal((1, 6, 3 * h)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((h, k)).astype(np.float32))
    seg = torch.tensor([[0, 0, 1, 1, 1, -1]], dtype=torch.int32)
    y = sc.short_conv(bcx, w, seg)
    b, c, x = bcx.split(h, dim=-1)
    bx = b * x
    want = torch.zeros(1, 6, h)
    for t, taps in ((0, [0]), (1, [0, 1]), (2, [2]), (3, [2, 3]), (4, [2, 3, 4])):
        for src in taps:
            want[0, t] += bx[0, src] * w[:, k - 1 - (t - src)]
        want[0, t] *= c[0, t]
    # f32 both ways, three products a channel: rounding only
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)


def test_bias_steers_the_choice_and_not_the_weights():
    """Scores 0.9, 0.8, 0.3, 0.1 by expert; a bias of +0.6 on expert 2
    chooses experts 0 and 2, weighted by their unbiased scores."""
    gate = torch.zeros(4, 4)
    gate[:, 0] = torch.logit(torch.tensor([0.9, 0.8, 0.3, 0.1]))
    x = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    r = moe_ops.moe_route(x, gate, torch.tensor([0.0, 0.0, 0.6, 0.0]), 2)
    assert r.offsets.tolist() == [0, 1, 1, 2, 2]  # one row each for experts 0 and 2
    torch.testing.assert_close(r.weight, torch.tensor([0.9, 0.3]) / (1.2 + 1e-6))
    unbiased = moe_ops.moe_route(x, gate, None, 2)
    assert unbiased.offsets.tolist() == [0, 1, 2, 2, 2]
    torch.testing.assert_close(unbiased.weight, torch.tensor([0.9, 0.8]) / (1.7 + 1e-6))


def _dense_moe(x, gate, bias, gateup, down, k, live=None):
    """Every expert on every token, weighted by the route: the block's
    function written out with no permutation."""
    s = torch.sigmoid(x @ gate.t())
    chosen = torch.topk(s + bias, k, dim=-1).indices
    w = s.gather(1, chosen)
    w = w / (w.sum(-1, keepdim=True) + 1e-6)
    inter = down.shape[-1]
    out = torch.zeros_like(x)
    for e in range(gate.shape[0]):
        gu = x @ gateup[e].t()
        y = (torch.nn.functional.silu(gu[:, :inter]) * gu[:, inter:]) @ down[e].t()
        out += (w * (chosen == e)).sum(-1, keepdim=True) * y
    if live is not None:
        out[~live] = 0
    return out


def test_expert_with_no_rows_and_padding_not_routed():
    g = torch.Generator().manual_seed(5)
    t, h, e, inter, k = 40, 16, 6, 8, 2
    x = torch.randn(t, h, generator=g)
    gate = torch.randn(e, h, generator=g)
    bias = torch.randn(e, generator=g) * 0.1
    bias[3] = -100.0  # expert 3 is never chosen
    gateup = torch.randn(e, 2 * inter, h, generator=g) * 0.3
    down = torch.randn(e, h, inter, generator=g) * 0.3
    live = torch.rand(t, generator=g) > 0.2
    counts = torch.zeros(3, dtype=torch.int64)
    r = moe_ops.moe_route(x, gate, bias, k, live=live, counts=counts)
    offs = r.offsets.tolist()
    assert offs[4] == offs[3] and offs[-1] == int(live.sum()) * k
    per = np.diff(offs)
    assert counts.tolist() == [int(live.sum()) * k, int(live.sum()) * k, int(per.max())]
    got = moe_ops.moe_experts(x, r, gateup, down)
    # f32; every expert on every token against the permuted rows: sums of
    # outputs of ~1-10 in another order
    torch.testing.assert_close(got, _dense_moe(x, gate, bias, gateup, down, k, live),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_gemm_path_matches_the_expert_loop(dtype):
    """The card's composition (``grouped_experts``: the gathered rows,
    ``torch._grouped_mm`` over the cumulative row ends, the SwiGLU pass,
    the second ``torch._grouped_mm``, the combine) run here with the plain
    SwiGLU, against the loop over experts; an expert with no rows and
    unrouted padding included. Ends given as the starts (an off-by-one in
    the offsets) must not pass."""
    g = torch.Generator().manual_seed(9)
    t, h, e, inter, k = 120, 32, 8, 16, 2
    x = torch.randn(t, h, generator=g).to(dtype)
    gate = torch.randn(e, h, generator=g).to(dtype)
    bias = torch.randn(e, generator=g) * 0.1
    bias[5] = -100.0  # expert 5 is never chosen
    gateup = (torch.randn(e, 2 * inter, h, generator=g) * 0.3).to(dtype)
    down = (torch.randn(e, h, inter, generator=g) * 0.3).to(dtype)
    live = torch.rand(t, generator=g) > 0.2
    r = moe_ops.moe_route(x, gate, bias, k, live=live)
    got = moe_ops.grouped_experts(x, r, gateup, down, moe_ops.swiglu_plain)
    want = moe_ops.moe_experts_plain(x, r, gateup, down)
    # the same products rounded at the same points: f32 sums in another
    # order, or (bf16) one rounding step of outputs of ~1-10
    tol = 1e-5 if dtype == torch.float32 else 2e-2 * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    assert bool((got[~live] == 0).all())
    shifted = dataclasses.replace(r, offsets=torch.cat([r.offsets[:1], r.offsets[:-1]]))
    bad = moe_ops.grouped_experts(x, shifted, gateup, down, moe_ops.swiglu_plain)
    assert not torch.allclose(bad.float(), want.float(), rtol=0, atol=tol)


DOCS = ["the cat sat on the mat", "dogs chase cats in the yard all day long",
        "qubits", "bond yields rose on inflation fears again", "a b c d e f g h",
        "chocolate cake with dark cocoa and cream"]


def test_packed_scores_equal_bucketed_scores_through_the_reranker():
    """The reranker's packed P(yes) against each pair scored alone: its
    left-padded row of the encoded batch through ``last_logits``."""
    model = _model()
    tok = HashTokenizer(vocab_size=model.cfg.vocab_size, max_len=128)
    packed = CrossEncoderReranker.from_causal_lm(model, None, tok, max_length=128)
    docs = [Document(content=d) for d in DOCS]
    ids, mask = (torch.from_numpy(a) for a in packed._encode_bucketed(
        [packed._render("what do cats do", d.content) for d in docs]))
    with torch.no_grad():
        a = packed.compute_scores("what do cats do", docs)
        last = torch.cat([model.last_logits(ids[i : i + 1], mask[i : i + 1])
                          for i in range(len(docs))])
    b = _p_yes(last, packed.yes_id, packed.no_id).numpy()
    assert np.ptp(a) > 1e-3
    # P(yes) in f32 from the same arithmetic on packed and padded rows
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_rerank_forward_span_counts_routed_assignments():
    model = _model()
    cfg = model.cfg
    tok = HashTokenizer(vocab_size=cfg.vocab_size, max_len=128)
    rr = CrossEncoderReranker.from_causal_lm(model, None, tok, max_length=128)
    tracer = tracing.get_tracer()
    tracer.reset()
    docs = [Document(content=d) for d in DOCS]
    rr.rerank_batch(["cats", "bonds"], [docs, docs[:3]], k=2)
    counts = tracer.summary()["rerank.forward"]["counts"]
    tokens = tracer.summary()["rerank.prompts"]["counts"]["tokens"]
    assert counts["moe_assignments"] == tokens * cfg.num_experts_per_tok * cfg.moe_layers
    assert tokens * cfg.num_experts_per_tok * cfg.moe_layers / cfg.num_experts <= \
        counts["moe_busiest"] <= counts["moe_assignments"]


def test_dense_variant_matches_hf_lfm2():
    """Every layer dense and no auto-adjusted width: the conv, attention and
    norm equations against HF's independent implementation, at f32."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    types = ["conv", "conv", "full_attention", "conv", "conv", "full_attention"]
    hf_cfg = transformers.Lfm2Config(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=6,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        norm_eps=1e-5, rope_theta=10000.0, conv_L_cache=3, block_auto_adjust_ff_dim=False,
        layer_types=types, tie_word_embeddings=True)
    hf_cfg._attn_implementation = "eager"
    hf = transformers.Lfm2ForCausalLM(hf_cfg).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            p.normal_(0.0, 0.2)
            if "norm" in name:
                p.add_(1.0)
    cfg = Lfm2MoeConfig.tiny(num_dense_layers=6)
    model = Lfm2MoeLM(cfg)
    model.load_state_dict(lfm2_moe_state_dict_from_hf(hf.state_dict(), cfg))
    ids = torch.randint(4, 128, (2, 17), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = hf(input_ids=ids).logits
        got = model(ids, torch.ones_like(ids, dtype=torch.bool))
    assert want.abs().max() > 1.0
    # f32 both ways; HF's conv runs as a Conv1d, its attention as eager
    # matmuls: ~4e-6 apart on logits of ~4
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_hf_bridge_stacks_experts():
    """An HF-named LFM2-MoE state_dict (per-expert w1/w2/w3, the conv's
    (H, 1, K) weight, separate q/k/v) loads into the port's names."""
    model = _model()
    cfg = model.cfg
    inter, sd = cfg.moe_intermediate_size, model.state_dict()
    hf = {"model.embed_tokens.weight": sd["embed_tokens.weight"],
          "model.embedding_norm.weight": sd["embedding_norm.weight"]}
    for i, kind in enumerate(cfg.layer_types):
        p, q = f"layers.{i}.", f"model.layers.{i}."
        hf[q + "operator_norm.weight"] = sd[p + "operator_norm.weight"]
        hf[q + "ffn_norm.weight"] = sd[p + "ffn_norm.weight"]
        if kind == "full_attention":
            qkv = sd[p + "self_attn.qkv_proj.weight"]
            nq = cfg.num_attention_heads * cfg.head_dim
            nk = cfg.num_key_value_heads * cfg.head_dim
            hf[q + "self_attn.q_proj.weight"] = qkv[:nq]
            hf[q + "self_attn.k_proj.weight"] = qkv[nq:nq + nk]
            hf[q + "self_attn.v_proj.weight"] = qkv[nq + nk:]
            hf[q + "self_attn.out_proj.weight"] = sd[p + "self_attn.o_proj.weight"]
            hf[q + "self_attn.q_layernorm.weight"] = sd[p + "self_attn.q_norm.weight"]
            hf[q + "self_attn.k_layernorm.weight"] = sd[p + "self_attn.k_norm.weight"]
        else:
            hf[q + "conv.in_proj.weight"] = sd[p + "conv.in_proj.weight"]
            hf[q + "conv.conv.weight"] = sd[p + "conv.weight"][:, None, :]
            hf[q + "conv.out_proj.weight"] = sd[p + "conv.out_proj.weight"]
        f, g = p + "feed_forward.", q + "feed_forward."
        if i < cfg.num_dense_layers:
            w13, di = sd[f + "gateup_proj.weight"], cfg.intermediate_size
            hf[g + "w1.weight"], hf[g + "w3.weight"] = w13[:di], w13[di:]
            hf[g + "w2.weight"] = sd[f + "down_proj.weight"]
            continue
        hf[g + "gate.weight"] = sd[f + "gate.weight"]
        hf[g + "expert_bias"] = sd[f + "expert_bias"]
        for e in range(cfg.num_experts):
            hf[g + f"experts.{e}.w1.weight"] = sd[f + "gateup_proj"][e, :inter]
            hf[g + f"experts.{e}.w3.weight"] = sd[f + "gateup_proj"][e, inter:]
            hf[g + f"experts.{e}.w2.weight"] = sd[f + "down_proj"][e]
    back = lfm2_moe_state_dict_from_hf(hf, cfg)
    assert set(back) == set(sd)
    for name, t in sd.items():
        torch.testing.assert_close(back[name], t.float(), rtol=0, atol=0)


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Triton kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("h", [64, 2048])
def test_short_conv_kernel_matches_plain(cuda, h):
    g = torch.Generator().manual_seed(h)
    r, length = 3, 100
    bcx = torch.randn(r, length, 3 * h, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(h, 3, generator=g) * 0.5).to(cuda, torch.bfloat16)
    seg = torch.full((r, length), -1, dtype=torch.int32)
    seg[0, :40], seg[0, 40:41], seg[0, 41:97] = 0, 1, 2  # a one-token segment
    seg[1, 2:100] = 0
    seg[2, :] = torch.arange(length) // 7
    seg = seg.to(cuda)
    before = sc.launches
    got = sc.short_conv(bcx, w, seg)
    assert sc.launches == before + 1
    want = sc.short_conv_plain(bcx.cpu(), w.cpu(), seg.cpu())
    # bf16 out of f32 registers on both sides; sums in another order can
    # land one bf16 step (2^-8 relative) apart
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("t,h,inter,e,k", [(300, 64, 32, 8, 2), (4000, 2048, 1792, 32, 4)])
def test_moe_kernels_match_plain(cuda, t, h, inter, e, k):
    g = torch.Generator().manual_seed(t)
    x = torch.randn(t, h, generator=g)
    gate = torch.randn(e, h, generator=g) * 0.05
    bias = torch.randn(e, generator=g) * 0.05
    bias[1] = -100.0  # an expert with no rows
    gateup = torch.randn(e, 2 * inter, h, generator=g) * 0.02
    down = torch.randn(e, h, inter, generator=g) * 0.02
    live = torch.rand(t, generator=g) > 0.1
    dev = [a.to(cuda) for a in (x, gate, bias, gateup, down, live)]
    xb, gb, ub, db = (dev[0].bfloat16(), dev[1].bfloat16(), dev[3].bfloat16(),
                      dev[4].bfloat16())
    counts = torch.zeros(3, dtype=torch.int64, device=cuda)
    r = moe_ops.moe_route(xb, gb, dev[2], k, live=dev[5], counts=counts)
    offs = r.offsets.cpu().tolist()
    assert offs[2] == offs[1] and offs[-1] == int(live.sum()) * k
    before = moe_ops.launches
    got = moe_ops.moe_experts(xb, r, ub, db)
    assert moe_ops.launches == before + 1  # the SwiGLU pass; the GEMMs are torch._grouped_mm
    r_cpu = moe_ops.Routing(*(getattr(r, f.name).cpu() if torch.is_tensor(getattr(r, f.name))
                              else getattr(r, f.name) for f in dataclasses.fields(r)))
    want = moe_ops.moe_experts_plain(xb.cpu(), r_cpu, ub.cpu(), db.cpu())
    scale = want.float().abs().max()
    # the gate/up rows, the weighted hidden rows and the down rows round at
    # the same points; the tensor cores' f32 sums over 1,792-2,048 terms
    # differ in order from the CPU's, a few bf16 steps of the largest output
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=0, atol=2e-2 * scale)
    assert counts.cpu().tolist() == [offs[-1], offs[-1], int(np.diff(offs).max())]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,inter", [(37, 32), (14336 * 4, 1792)])
def test_swiglu_kernel_matches_plain(cuda, rows, inter):
    g = torch.Generator().manual_seed(rows)
    gu = (torch.randn(rows, 2 * inter, generator=g) * 3).to(cuda, torch.bfloat16)
    w = torch.rand(rows, generator=g).to(cuda)
    n_live = torch.tensor([rows - 5], dtype=torch.int32, device=cuda)
    before = moe_ops.launches
    got = moe_ops.swiglu(gu, w, n_live)
    assert moe_ops.launches == before + 1
    want = moe_ops.swiglu_plain(gu, w, n_live)
    # f32 on both sides, rounded once to bf16: at most one bf16 step apart
    # where the two f32 results straddle a rounding boundary
    torch.testing.assert_close(got[: rows - 5].float(), want[: rows - 5].float(),
                               rtol=8e-3, atol=1e-6)


def _card_model(device):
    cfg = Lfm2MoeConfig.tiny(vocab_size=256, hidden_size=256, intermediate_size=512,
                             moe_intermediate_size=128, num_attention_heads=4,
                             num_key_value_heads=2, dtype=torch.bfloat16,
                             param_dtype=torch.bfloat16)
    return init_lfm2_moe(cfg, seed=3, device=device)


@pytest.mark.gpu
def test_forward_on_the_card_matches_reference_without_host_sync(cuda):
    model = _card_model(cuda)
    toks = _tokens(np.random.default_rng(4), (130, 7, 61, 250, 33, 90), vocab=256)
    ids, mask = _left_padded(toks)
    rows, _, last = pack_prompts(ids.numpy(), mask.numpy(), 256)
    r = torch.from_numpy(rows).to(cuda)
    last_d = torch.from_numpy(last).to(cuda)
    counts = torch.zeros(3, dtype=torch.int64, device=cuda)
    with torch.no_grad():
        model.last_logits_packed(r[0], r[1], r[2], last_d, counts=counts)  # builds the kernels
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = model.last_logits_packed(r[0], r[1], r[2], last_d, counts=counts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    want = ref.last_logits(model.state_dict(), toks, _cfg_dict(model.cfg), cuda)
    # bf16 program against the f32 reference: logits of ~1, bf16 steps ~4e-3
    # through 6 layers, and a near-tie in the router may choose apart
    err = (got.float() - want).abs()
    assert err.max() < 0.1 and err.mean() < 0.01
    live = sum(len(t) for t in toks)  # two forwards' counts
    assert counts.tolist()[0] == 2 * live * model.cfg.moe_layers * model.cfg.num_experts_per_tok
