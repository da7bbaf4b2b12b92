"""The port's Granite 4.0-H model (``models/granite_hybrid.py``) and its new
or extended ops (``ops/ssd_scan.py``, ``ops/short_conv.py``'s Mamba form,
``ops/rms_norm.py``'s residual scale and gated norm, ``ops/moe.py``'s
softmax scoring and held experts) on the CPU at a tiny size, against the
benchmark's plain f32 reference (``bench_torch/reference/granite_hybrid.py``,
whose scan is the token-by-token recurrence) and, with every expert held,
against HF transformers' ``GraniteMoeHybridForCausalLM``. The tiny model
has the layer pattern Mamba, attention, Mamba, Mamba, 8 experts, top 3,
and holds experts 0-3.

The cases marked ``gpu`` need a CUDA card (a CUDA or Triton kernel has no
CPU mode) and skip here; on a machine with a card run

    python -m pytest tests/test_torch_granite_hybrid.py --noconftest -m gpu -q

(this file imports no JAX).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bench_torch.reference import granite_hybrid as ref
from rag_arc_tpu_torch.models import granite_hybrid
from rag_arc_tpu_torch.models.convert import granite_hybrid_state_dict_from_hf
from rag_arc_tpu_torch.models.granite_hybrid import (
    GraniteHybridConfig, GraniteHybridLM, init_granite_hybrid,
)
from rag_arc_tpu_torch.models.tokenizer import HashTokenizer
from rag_arc_tpu_torch.ops import moe as moe_ops
from rag_arc_tpu_torch.ops import rms_norm as rn
from rag_arc_tpu_torch.ops import short_conv as sc
from rag_arc_tpu_torch.ops import ssd_scan as ss
from rag_arc_tpu_torch.rerank.cross_encoder import CrossEncoderReranker, _p_yes, pack_prompts
from rag_arc_tpu_torch.utils import tracing
from rag_arc_tpu_torch.utils.data_model import Document

# f32 on both sides; the two sum in other orders (the chunked scan against
# the recurrence, einsum against matmul, a gather and sum against
# index_add), ~1e-7 apart on logits of ~0.1-0.5 (divided by 16)
F32_TOL = 2e-5
# the scan's state readout (D = 0) against the f32 token recurrence at the
# served shape, the worst head's relative L2 error: the kernel reads ~0.0024
# (its bf16 output and product operands), a scan that holds its state in
# bf16 ~0.005 on the slowest-forgetting heads
SSD_STATE_TOL = 0.0035


def _cfg_dict(cfg: GraniteHybridConfig) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _model(seed=0, **kw):
    """The tiny model, its matrices scaled up from N(0, 0.02) so that every
    layer moves the logits (and ties in the router are rare), and its scan
    slow to forget (A in [0.2, 1], dt near 0.01), so that a state carried
    across a segment start would still show ~25 tokens on."""
    model = init_granite_hybrid(GraniteHybridConfig.tiny(**kw), seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2 and "conv1d" not in name:
                p.mul_(10.0)
            elif name.endswith("A_log"):
                p.copy_(torch.log(0.2 + 0.8 * torch.rand(p.shape, generator=g)))
            elif name.endswith("dt_bias"):
                p.copy_(granite_hybrid.inverse_softplus(torch.full(p.shape, 0.01)))
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
    toks = _tokens(np.random.default_rng(1), (1, 2, 5, 17, 30, 9, 70))
    ids, mask = _left_padded(toks)
    want = ref.last_logits(model.state_dict(), toks, _cfg_dict(model.cfg), "cpu")
    with torch.no_grad():
        got = model.last_logits(ids, mask)
        rows, _, last = pack_prompts(ids.numpy(), mask.numpy(), 96)
        r = torch.from_numpy(rows)
        packed = model.last_logits_packed(r[0], r[1], r[2], torch.from_numpy(last))
    assert rows.shape[1] < len(toks)  # several sequences share a row
    assert want.abs().max() > 0.2
    torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL)
    torch.testing.assert_close(packed, want, rtol=0, atol=F32_TOL)


def _hf_pair(attn_impl, seed=0):
    """HF's model at the tiny widths with non-trivial weights, and the port
    (every expert held) loaded from its state_dict through the name map."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    cfg = GraniteHybridConfig.tiny(held_experts=None, attn_impl=attn_impl)
    hf_cfg = transformers.GraniteMoeHybridConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        shared_intermediate_size=cfg.shared_intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers, layer_types=list(cfg.layer_types),
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads,
        max_position_embeddings=cfg.max_position_embeddings, mamba_n_heads=cfg.mamba_n_heads,
        mamba_d_head=cfg.mamba_d_head, mamba_d_state=cfg.mamba_d_state, mamba_n_groups=1,
        mamba_d_conv=cfg.mamba_d_conv, mamba_expand=cfg.mamba_expand, mamba_chunk_size=8,
        mamba_conv_bias=True, mamba_proj_bias=False, num_local_experts=cfg.num_local_experts,
        num_experts_per_tok=cfg.num_experts_per_tok,
        embedding_multiplier=cfg.embedding_multiplier,
        attention_multiplier=cfg.attention_multiplier,
        residual_multiplier=cfg.residual_multiplier, logits_scaling=cfg.logits_scaling,
        rms_norm_eps=cfg.rms_norm_eps, position_embedding_type="nope",
        tie_word_embeddings=True)
    hf_cfg._attn_implementation = "eager"
    hf = transformers.GraniteMoeHybridForCausalLM(hf_cfg).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if name.endswith("A_log"):
                p.copy_(torch.log(1 + 15 * torch.rand(p.shape)))
            elif name.endswith("dt_bias"):
                p.copy_(0.5 * torch.randn(p.shape) - 2.0)
            elif name.endswith(".D"):
                p.copy_(1 + 0.2 * torch.randn(p.shape))
            elif "conv1d" in name:
                p.normal_(0.0, 0.5)
            else:
                p.normal_(0.0, 0.3)
                if "norm" in name:
                    p.add_(1.0)
    model = GraniteHybridLM(cfg).eval()
    model.load_state_dict(granite_hybrid_state_dict_from_hf(hf.state_dict(), cfg))
    return hf, model


@pytest.mark.parametrize("attn_impl", ["auto", "einsum"])
def test_every_expert_held_matches_hf_granite(attn_impl):
    """Every expert held: the port and the reference against HF's
    independent implementation, at f32, on unpadded rows (HF's torch path
    takes no packed segments)."""
    hf, model = _hf_pair(attn_impl)
    ids = torch.randint(4, 128, (2, 21), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = hf(input_ids=ids).logits
        got = model(ids, torch.ones_like(ids, dtype=torch.bool))
    assert want.abs().max() > 0.2
    # f32 both ways; HF's scan is chunked by 8 with its own sums, its conv
    # a Conv1d: ~1e-7 apart on logits of ~0.1-1 (divided by 16)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    toks = [row.tolist() for row in ids]
    back = ref.last_logits(model.state_dict(), toks, _cfg_dict(model.cfg), "cpu")
    torch.testing.assert_close(back, want[:, -1], rtol=0, atol=1e-5)


def _row(parts, length):
    """One packed row of the token lists ``parts`` laid end to end."""
    ids = torch.zeros((1, length), dtype=torch.long)
    pos = torch.zeros((1, length), dtype=torch.long)
    seg = torch.full((1, length), -1, dtype=torch.int32)
    col, last = 0, []
    for s, toks in enumerate(parts):
        ids[0, col:col + len(toks)] = torch.tensor(toks)
        pos[0, col:col + len(toks)] = torch.arange(len(toks))
        seg[0, col:col + len(toks)] = s
        col += len(toks)
        last.append(col - 1)
    return ids, pos, seg, torch.tensor(last)


def _scan_without_resets(xbc, dt, a_log, dt_bias, d, seg, **kw):
    """A scan that carries its state across segment starts (padding still
    masked)."""
    return ss.ssd_scan_plain(xbc, dt, a_log, dt_bias, d, torch.where(seg >= 0, 0, -1)
                             .to(seg.dtype), **kw)


@pytest.mark.parametrize("start", [0, 5, 40, 63, 64])
def test_packed_pair_equals_pair_alone(start, monkeypatch):
    """A pair of 90 tokens starting at column 0, 5, 40, 63 or 64 of its row
    (so it starts mid-chunk or on a chunk edge of the scan's 64, and
    crosses one or two edges), with a filler segment before it and another
    pair after it, reads as each run alone; a scan that carries its state
    across segment starts fails the same check."""
    model = _model()
    rng = np.random.default_rng(start)
    parts = [p for p in _tokens(rng, (start, 90, 23)) if p]
    row = _row(parts, 200)
    with torch.no_grad():
        want = torch.cat([model.last_logits(*_left_padded([t])) for t in parts])
        got = model.last_logits_packed(*row)
        torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL)
        monkeypatch.setattr(granite_hybrid, "ssd_scan", _scan_without_resets)
        crossed = model.last_logits_packed(*row)
    assert (crossed[-1] - want[-1]).abs().max() > 10 * F32_TOL
    if start:
        assert (crossed[-2] - want[-2]).abs().max() > 10 * F32_TOL


def _scan_inputs(seed, r, length, heads, p, n):
    g = torch.Generator().manual_seed(seed)
    xbc = torch.randn(r, length, heads * p + 2 * n, generator=g)
    dt = torch.randn(r, length, heads, generator=g)
    a_log = torch.log(1 + 15 * torch.rand(heads, generator=g))
    dt_bias = torch.randn(heads, generator=g) - 1.0
    d = torch.randn(heads, generator=g)
    return xbc, dt, a_log, dt_bias, d


def _scan_by_recurrence(xbc, dt, a_log, dt_bias, d, seg, heads, p, n):
    """The reference's recurrence run over each segment alone."""
    y = torch.zeros(xbc.shape[0], xbc.shape[1], heads * p)
    for r in range(seg.shape[0]):
        for s in sorted(set(seg[r].tolist()) - {-1}):
            cols = torch.nonzero(seg[r] == s).flatten()
            v = xbc[r, cols][None]
            step = F.softplus(dt[r, cols] + dt_bias)[None]
            out = ref.ssd_sequential(v[..., : heads * p].reshape(1, -1, heads, p),
                                     v[..., heads * p : heads * p + n], v[..., heads * p + n:],
                                     step, a_log, d)
            y[r, cols] = out.reshape(-1, heads * p)
    return y


@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_chunked_scan_matches_the_recurrence(chunk):
    """Segments that start mid-chunk, on an edge, span several chunks, a
    one-token segment, padding inside a row and at its end."""
    heads, p, n = 3, 4, 5
    xbc, dt, a_log, dt_bias, d = _scan_inputs(chunk, 2, 77, heads, p, n)
    seg = torch.full((2, 77), -1, dtype=torch.int32)
    seg[0, :10], seg[0, 10:11], seg[0, 11:48], seg[0, 48:70] = 0, 1, 2, 3
    seg[1, 3:64], seg[1, 64:] = 0, 1
    got = ss.ssd_scan_plain(xbc, dt, a_log, dt_bias, d, seg, heads=heads, head_dim=p,
                            d_state=n, chunk=chunk)
    want = _scan_by_recurrence(xbc, dt, a_log, dt_bias, d, seg, heads, p, n)
    assert want.abs().max() > 1.0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert bool((got[seg < 0] == 0).all())


def _dense_moe(x, router, gateup, down, k, held):
    """Every expert of the range on every token, weighted by the softmax
    over the top-k logits: the sparse block written out with no
    permutation."""
    top, chosen = torch.topk(x @ router.t(), k, dim=-1)
    w = torch.softmax(top, dim=-1)
    inter = down.shape[-1]
    out = torch.zeros_like(x)
    lo, hi = held
    for e in range(lo, hi):
        gu = x @ gateup[e - lo].t()
        y = (F.silu(gu[:, :inter]) * gu[:, inter:]) @ down[e - lo].t()
        out += (w * (chosen == e)).sum(-1, keepdim=True) * y
    return out


def test_softmax_route_sorts_experts_not_held_past_the_held():
    g = torch.Generator().manual_seed(3)
    t, h, e, inter, k = 50, 16, 8, 8, 3
    x = torch.randn(t, h, generator=g)
    router = torch.randn(e, h, generator=g)
    gateup = torch.randn(e, 2 * inter, h, generator=g) * 0.3
    down = torch.randn(e, h, inter, generator=g) * 0.3
    live = torch.rand(t, generator=g) > 0.2
    counts = torch.zeros(3, dtype=torch.int64)
    r = moe_ops.moe_route(x, router, None, k, scoring="softmax", held=(2, 6), live=live,
                          counts=counts)
    chosen = torch.topk(x @ router.t(), k, dim=-1).indices
    on_held = int(((chosen >= 2) & (chosen < 6))[live].sum())
    assert r.offsets.numel() == 5 and int(r.offsets[-1]) == on_held
    assert counts.tolist() == [int(live.sum()) * k, on_held,
                               int(np.diff(r.offsets.tolist()).max())]
    got = moe_ops.moe_experts(x, r, gateup[2:6], down[2:6])
    want = _dense_moe(x, router, gateup[2:6], down[2:6], k, (2, 6))
    want[~live] = 0
    # f32; every expert on every token against the permuted rows
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    card = moe_ops.grouped_experts(x, r, gateup[2:6], down[2:6], moe_ops.swiglu_plain)
    torch.testing.assert_close(card, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("held", [(0, 8), (2, 6)])
def test_combine_reads_no_row_past_the_held_ones(held):
    """The rows past the held experts' are never written on the card: with
    NaN there, each token's sum still takes only its computed rows, and with
    every expert held (no padding) the last row counts as any other."""
    g = torch.Generator().manual_seed(held[0])
    t, h, k, e = 40, 16, 3, 8
    x = torch.randn(t, h, generator=g)
    live = torch.ones(t, dtype=torch.bool)
    live[-5:] = held != (2, 6)  # padding only in the cut case
    r = moe_ops.moe_route(x, torch.randn(e, h, generator=g), None, k, scoring="softmax",
                          held=held, live=live)
    rows = torch.randn(t * k, h, generator=g)
    end = int(r.offsets[-1])
    rows[end:] = float("nan")
    got = moe_ops._combine(rows.clone(), r)
    computed = (r.slot < end).view(t, k, 1)
    want = torch.where(computed, rows[r.slot].view(t, k, h), 0).sum(dim=1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert (end < t * k) == (held == (2, 6))


def test_expert_shares_add_up_to_the_uncut_layer():
    """The two halves of the experts (0-3 and 4-7, as two cards hold them)
    add up to the uncut layer, the shared expert counted once: in the
    port's layer and in the reference."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 9, 32, generator=g)
    ctx_live = torch.ones(18, dtype=torch.bool)
    whole = _model(held_experts=None)
    sd = whole.state_dict()
    parts = []
    for held in ((0, 4), (4, 8)):
        part = GraniteHybridLM(GraniteHybridConfig.tiny(held_experts=held)).eval()
        cut = {k: (v[held[0]:held[1]] if k.endswith(("gateup_proj", "down_proj"))
                   and "block_sparse_moe" in k else v) for k, v in sd.items()}
        part.load_state_dict(cut)
        parts.append(part)
    ctx = granite_hybrid._GraniteContext(False, torch.zeros(2, 9, dtype=torch.int32), ctx_live,
                                         None, None)
    with torch.no_grad():
        def ffn(model):
            layer = model.layers[0]
            return layer.block_sparse_moe(x, ctx), layer.shared_mlp(x, ctx)

        (m_all, s_all), (m_a, s_a), (m_b, s_b) = ffn(whole), ffn(parts[0]), ffn(parts[1])
    assert torch.equal(s_a, s_all) and torch.equal(s_b, s_all)
    torch.testing.assert_close(m_a + m_b, m_all, rtol=0, atol=1e-5)
    assert m_a.abs().max() > 0.1 and m_b.abs().max() > 0.1
    cfg = _cfg_dict(whole.cfg)
    lw = {k: v for k, v in sd.items() if k.startswith("layers.0.")}
    full = ref.feed_forward(x, lw, "layers.0.", cfg)
    halves = [ref.feed_forward(x, {k: (v[lo:hi] if k.endswith(("gateup_proj", "down_proj"))
                                       and "block_sparse_moe" in k else v)
                                   for k, v in lw.items()}, "layers.0.",
                               dict(cfg, held_experts=(lo, hi))) for lo, hi in ((0, 4), (4, 8))]
    shared = ref._swiglu(x.reshape(-1, 32), lw["layers.0.shared_mlp.gateup_proj.weight"],
                         lw["layers.0.shared_mlp.down_proj.weight"], ref.f32_mm).view_as(x)
    torch.testing.assert_close(halves[0] + halves[1] - shared, full, rtol=0, atol=1e-5)
    torch.testing.assert_close(full, m_all + s_all, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rms_norm_scale_one_is_the_former_add(dtype):
    """With s = 1 the stream is bit for bit ``x + delta`` and the norm the
    former chain's; with s = 0.22 the sum is ``x + 0.22 · delta`` in f32,
    rounded once."""
    g = torch.Generator().manual_seed(11)
    x, delta = (torch.randn(5, 64, generator=g).to(dtype) for _ in range(2))
    w = (1 + 0.1 * torch.randn(64, generator=g)).to(dtype)
    got_x, got_y = rn.add_rms_norm(x, delta, w, 1e-5, 1.0)
    x_new = x + delta
    x32 = x_new.float()
    want_y = (x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + 1e-5)
              * w.float()).to(dtype)
    assert torch.equal(got_x, x_new) and torch.equal(got_y, want_y)
    assert torch.equal(rn.add_rms_norm(x, delta, w, 1e-5)[1], got_y)
    scaled, _ = rn.add_rms_norm(x, delta, w, 1e-5, 0.22)
    assert torch.equal(scaled, (x.float() + 0.22 * delta.float()).to(dtype))


def test_gated_rms_norm_matches_hf():
    transformers = pytest.importorskip("transformers")
    from transformers.models.granitemoehybrid import modeling_granitemoehybrid as hf_mod

    g = torch.Generator().manual_seed(13)
    y, z = torch.randn(2, 7, 48, generator=g), torch.randn(2, 7, 48, generator=g)
    norm = hf_mod.GraniteMoeHybridRMSNormGated(48, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.2 * torch.randn(48, generator=g))
        want = norm(y, z)
    got = rn.gated_rms_norm(y, z, norm.weight.detach(), 1e-5)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    del transformers


def test_mamba_conv_stops_at_segments_and_padding():
    """The Mamba form from a column slice of a wider projection: four taps,
    a bias and a SiLU, zero before a row's start, across a segment start
    and from padding; padding's own output zero."""
    rng = np.random.default_rng(3)
    c, k = 4, 4
    proj = torch.from_numpy(rng.standard_normal((1, 7, 3 + c + 2)).astype(np.float32))
    v = proj[..., 3:3 + c]
    w = torch.from_numpy(rng.standard_normal((c, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    seg = torch.tensor([[0, 0, 0, 0, 0, 1, -1]], dtype=torch.int32)
    y = sc.mamba_conv(v, w, b, seg)
    assert y.is_contiguous() and y.shape == (1, 7, c)
    want = torch.zeros(1, 7, c)
    for t, taps in ((0, [0]), (1, [0, 1]), (2, [0, 1, 2]), (3, [0, 1, 2, 3]), (4, [1, 2, 3, 4]),
                    (5, [5])):
        acc = b.clone()
        for src in taps:
            acc += v[0, src] * w[:, k - 1 - (t - src)]
        want[0, t] = F.silu(acc)
    # f32 both ways, four products a channel: rounding only
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)


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


@pytest.mark.parametrize("held", [(0, 4), None])
def test_rerank_forward_span_counts_held_assignments(held, monkeypatch):
    """``moe_held`` is the routed assignments that landed on held experts,
    counted on the device and read back with the scores: all of them where
    every expert is held."""
    model = _model(held_experts=held)
    cfg = model.cfg
    seen = []
    route = granite_hybrid.moe_route

    def recorded(*a, **kw):
        r = route(*a, **kw)
        seen.append(int(r.offsets[-1]))
        return r

    monkeypatch.setattr(granite_hybrid, "moe_route", recorded)
    tok = HashTokenizer(vocab_size=cfg.vocab_size, max_len=128)
    rr = CrossEncoderReranker.from_causal_lm(model, None, tok, max_length=128)
    tracer = tracing.get_tracer()
    tracer.reset()
    docs = [Document(content=d) for d in DOCS]
    rr.rerank_batch(["cats", "bonds"], [docs, docs[:3]], k=2)
    counts = tracer.summary()["rerank.forward"]["counts"]
    tokens = tracer.summary()["rerank.prompts"]["counts"]["tokens"]
    assert counts["moe_assignments"] == tokens * cfg.num_experts_per_tok * cfg.num_hidden_layers
    assert counts["moe_held"] == sum(seen)
    if held is None:
        assert counts["moe_held"] == counts["moe_assignments"]
    else:
        assert 0 < counts["moe_held"] < counts["moe_assignments"]
    assert 0 < counts["moe_busiest"] <= counts["moe_held"]


def test_hf_bridge_cuts_the_experts_to_the_held_range():
    hf, whole = _hf_pair("auto")
    cfg = GraniteHybridConfig.tiny(held_experts=(4, 8))
    part = granite_hybrid_state_dict_from_hf(hf.state_dict(), cfg)
    sd = whole.state_dict()
    assert set(part) == set(sd)
    for name, t in sd.items():
        if "block_sparse_moe" in name and name.endswith(("gateup_proj", "down_proj")):
            t = t[4:8]
        torch.testing.assert_close(part[name], t.float(), rtol=0, atol=0)


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA and Triton kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _served_segments(rng, rows, length, lo=60, hi=230):
    seg = np.full((rows, length), -1, dtype=np.int32)
    for r in range(rows):
        col = s = 0
        while True:
            n = int(rng.integers(lo, hi + 1))
            if col + n > length:
                n = length - col
                if n < lo:
                    break
            seg[r, col:col + n] = s
            col, s = col + n, s + 1
    return torch.from_numpy(seg)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,length,heads", [(3, 100, 4), (4, 512, 128)])
def test_ssd_scan_kernel_matches_plain(cuda, rows, length, heads):
    p, n = 64, 128
    g = torch.Generator().manual_seed(rows)
    width = heads * p + 2 * n
    proj = torch.randn(rows, length, width + heads + 8, generator=g)
    xbc = proj[..., :width].contiguous().to(cuda, torch.bfloat16)
    dt_all = proj.to(cuda, torch.bfloat16)
    dt = dt_all[..., width:width + heads]  # a column slice, as the model passes it
    a_log = torch.log(1 + 15 * torch.rand(heads, generator=g)).to(cuda)
    dt_bias = (torch.randn(heads, generator=g) - 3.0).to(cuda)
    d = torch.ones(heads).to(cuda)
    seg = _served_segments(np.random.default_rng(rows), rows, length,
                           *((10, 40) if length < 200 else (60, 230)))
    seg[0, -7:] = -1
    seg = seg.to(cuda)
    before = ss.launches
    got = ss.ssd_scan(xbc, dt, a_log, dt_bias, d, seg, heads=heads, head_dim=p, d_state=n)
    assert ss.launches == before + 1
    want = ss.ssd_scan_plain(xbc, dt, a_log, dt_bias, d, seg, heads=heads, head_dim=p,
                             d_state=n)
    scale = float(want.float().abs().max())
    # f32 state on both sides; the kernel's products on bf16 operands and
    # its output rounded once to bf16: within a few bf16 steps of the
    # largest output
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=1e-2 * scale)
    assert bool((got[seg < 0] == 0).all())


def _worst_head_err(got, want, seg, heads):
    """The largest relative L2 error of one head's live outputs."""
    live = seg >= 0
    e = (got.float() - want)[live].reshape(-1, heads, want.shape[-1] // heads)
    w = want[live].reshape(e.shape)
    return float((e.norm(dim=(0, 2)) / w.norm(dim=(0, 2))).max())


@pytest.mark.gpu
def test_ssd_scan_kernel_holds_the_f32_state(cuda):
    """At the served shape (28 rows of 512, 128 heads of 64, state 128, the
    cell's dt and A ranges) with D = 0, so y is the state's readout alone:
    the kernel stays within SSD_STATE_TOL of the f32 token recurrence, and
    the same recurrence with its state held in bf16 does not."""
    rows, length, heads, p, n = 28, 512, 128, 64, 128
    g = torch.Generator().manual_seed(21)
    xbc = F.silu(torch.randn(rows, length, heads * p + 2 * n, generator=g)).to(cuda,
                                                                              torch.bfloat16)
    dt = torch.randn(rows, length, heads, generator=g).to(cuda, torch.bfloat16)
    a_log = torch.log(1 + 15 * torch.rand(heads, generator=g)).to(cuda)
    dt0 = torch.exp(np.log(0.001) + (np.log(0.1) - np.log(0.001)) * torch.rand(heads, generator=g))
    dt_bias = (dt0 + torch.log(-torch.expm1(-dt0))).to(cuda)
    d = torch.zeros(heads, device=cuda)
    seg = _served_segments(np.random.default_rng(21), rows, length).to(cuda)
    got = ss.ssd_scan(xbc, dt, a_log, dt_bias, d, seg, heads=heads, head_dim=p, d_state=n)
    want = ref.ssd_packed(xbc, dt, a_log, dt_bias, d, seg, heads, p, n)
    held16 = ref.ssd_packed(xbc, dt, a_log, dt_bias, d, seg, heads, p, n, torch.bfloat16)
    err = _worst_head_err(got, want, seg, heads)
    control = _worst_head_err(held16.to(torch.bfloat16), want, seg, heads)
    print(f"worst head's relative L2 error: kernel {err:.5f}, bf16 state {control:.5f}")
    assert err < SSD_STATE_TOL < control


@pytest.mark.gpu
@pytest.mark.parametrize("c", [72, 8448])
def test_mamba_conv_kernel_matches_plain(cuda, c):
    g = torch.Generator().manual_seed(c)
    r, length = 3, 100
    proj = torch.randn(r, length, c + 40, generator=g).to(cuda, torch.bfloat16)
    v = proj[..., 24:24 + c]
    w = (torch.randn(c, 4, generator=g) * 0.5).to(cuda, torch.bfloat16)
    b = (torch.randn(c, generator=g) * 0.1).to(cuda, torch.bfloat16)
    seg = torch.full((r, length), -1, dtype=torch.int32)
    seg[0, :40], seg[0, 40:41], seg[0, 41:97] = 0, 1, 2
    seg[1, 2:100] = 0
    seg[2, :] = torch.arange(length) // 7
    seg = seg.to(cuda)
    before = sc.launches
    got = sc.mamba_conv(v, w, b, seg)
    assert sc.launches == before + 1
    want = sc.mamba_conv_plain(v.cpu(), w.cpu(), b.cpu(), seg.cpu())
    # bf16 out of f32 registers on both sides: one bf16 step apart at most
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("t,c", [(37, 48), (14336, 8192)])
def test_gated_rms_norm_kernel_matches_plain(cuda, t, c):
    g = torch.Generator().manual_seed(t)
    proj = torch.randn(t, 2 * c + 16, generator=g).to(cuda, torch.bfloat16)
    y = torch.randn(t, c, generator=g).to(cuda, torch.bfloat16)
    z = proj[:, 8:8 + c]
    w = (1 + 0.1 * torch.randn(c, generator=g)).to(cuda, torch.bfloat16)
    before = (rn.launches, rn.launches_gated)
    got = rn.gated_rms_norm(y, z, w, 1e-5)
    assert (rn.launches, rn.launches_gated) == (before[0], before[1] + 1)
    want = rn.gated_rms_norm_plain(y, z, w, 1e-5)
    # f32 inside both, rounded once: one bf16 step apart at most
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3, atol=1e-6)


@pytest.mark.gpu
def test_add_rms_norm_kernel_with_a_residual_scale(cuda):
    g = torch.Generator().manual_seed(22)
    x, delta = (torch.randn(1000, 4096, generator=g).to(cuda, torch.bfloat16) for _ in range(2))
    w = (1 + 0.1 * torch.randn(4096, generator=g)).to(cuda, torch.bfloat16)
    got_x, got_y = rn.add_rms_norm(x, delta, w, 1e-5, 0.22)
    want_x, want_y = rn.add_rms_norm_plain(x, delta, w, 1e-5, 0.22)
    # the kernel's x + s·delta is one fused multiply-add, the plain chain's
    # a product and a sum: the two f32 results may straddle a bf16 rounding
    # boundary, one bf16 step apart (or, where the sum cancels, ~1e-9 apart)
    torch.testing.assert_close(got_x.float(), want_x.float(), rtol=8e-3, atol=1e-6)
    assert float((got_x != want_x).float().mean()) < 1e-3
    torch.testing.assert_close(got_y.float(), want_y.float(), rtol=1.6e-2, atol=1e-6)
    one_x, one_y = rn.add_rms_norm(x, delta, w, 1e-5, 1.0)
    assert torch.equal(one_x, x + delta)


@pytest.mark.gpu
@pytest.mark.parametrize("t,h,inter,e,k,held", [(300, 64, 32, 8, 3, (0, 4)),
                                                (4000, 4096, 768, 72, 10, (0, 36))])
def test_held_experts_on_the_card_match_plain(cuda, t, h, inter, e, k, held):
    g = torch.Generator().manual_seed(t)
    x = torch.randn(t, h, generator=g).to(cuda, torch.bfloat16)
    router = (torch.randn(e, h, generator=g) * 0.05).to(cuda, torch.bfloat16)
    n = held[1] - held[0]
    gateup = (torch.randn(n, 2 * inter, h, generator=g) * 0.02).to(cuda, torch.bfloat16)
    down = (torch.randn(n, h, inter, generator=g) * 0.02).to(cuda, torch.bfloat16)
    live = (torch.rand(t, generator=g) > 0.1).to(cuda)
    counts = torch.zeros(3, dtype=torch.int64, device=cuda)
    r = moe_ops.moe_route(x, router, None, k, scoring="softmax", held=held, live=live,
                          counts=counts)
    before = moe_ops.launches
    got = moe_ops.moe_experts(x, r, gateup, down)
    assert moe_ops.launches == before + 1  # the SwiGLU pass
    r_cpu = moe_ops.Routing(*(getattr(r, f.name).cpu() if torch.is_tensor(getattr(r, f.name))
                              else getattr(r, f.name) for f in dataclasses.fields(r)))
    want = moe_ops.moe_experts_plain(x.cpu(), r_cpu, gateup.cpu(), down.cpu())
    scale = want.float().abs().max()
    # the same rounding points; the tensor cores' f32 sums in another order
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=0, atol=2e-2 * scale)
    assert bool((got[~live] == 0).all())
    offs = r.offsets.cpu().tolist()
    assert counts.cpu().tolist() == [int(live.sum()) * k, offs[-1], int(np.diff(offs).max())]


def _card_model(device):
    cfg = GraniteHybridConfig.tiny(vocab_size=256, hidden_size=128, intermediate_size=64,
                                   shared_intermediate_size=96, mamba_n_heads=4,
                                   mamba_d_head=64, mamba_d_state=128, num_attention_heads=2,
                                   num_key_value_heads=1, attention_multiplier=1 / 64,
                                   dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    return init_granite_hybrid(cfg, seed=3, device=device)


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
    # bf16 program against the f32 reference: logits of ~0.1-1 after the
    # division by 16, bf16 steps through 4 layers, and a near-tie in the
    # router may choose apart
    err = (got.float() - want).abs()
    assert err.max() < 0.05 and err.mean() < 0.01
    live = sum(len(t) for t in toks)  # two forwards' counts
    cfg = model.cfg
    assert counts.tolist()[0] == 2 * live * cfg.num_hidden_layers * cfg.num_experts_per_tok
