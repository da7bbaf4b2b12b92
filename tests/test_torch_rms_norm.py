"""The residual add + RMSNorm op (``ops/rms_norm.py``) and the decoder
loops that carry each layer's pending delta into the next norm
(``models/decoder.py``'s shell over ``models/qwen3.py`` and
``models/lfm2_moe.py``).

On the CPU: the plain version against the former chain (``x + delta``,
then ``RMSNorm.forward``) bit for bit; both tiny models against a copy of
the former per-module loop; the wrapper's refusals on a fake (``meta``)
device. The cases marked ``gpu`` need a CUDA card (a Triton kernel has no
CPU mode) and skip here; on a machine with a card run

    python -m pytest tests/test_torch_rms_norm.py --noconftest -m gpu -q

(this file imports no JAX).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rag_arc_tpu_torch.models import decoder, qwen3
from rag_arc_tpu_torch.models.lfm2_moe import Lfm2MoeConfig, init_lfm2_moe
from rag_arc_tpu_torch.models.decoder import RMSNorm, cast_linear
from rag_arc_tpu_torch.models.qwen3 import Qwen3Config, init_qwen3
from rag_arc_tpu_torch.ops import rms_norm as rn
from rag_arc_tpu_torch.rerank.cross_encoder import pack_prompts

EPS = 1e-6


def _former_chain(x, delta, weight, eps):
    """The decoders' chain before the fused op: the add, then the module."""
    if delta is not None:
        x = x + delta
    norm = RMSNorm(x.shape[-1], eps, x.dtype, param_dtype=weight.dtype)
    with torch.no_grad():
        norm.weight.copy_(weight)
    return x, norm(x)


def _operands(t, h, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(t, h, generator=g) * 3).to(dtype)
    delta = torch.randn(t, h, generator=g).to(dtype)
    weight = (1 + 0.1 * torch.randn(h, generator=g)).to(dtype)
    return x, delta, weight


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_delta", [True, False])
@pytest.mark.parametrize("h", [32, 1024, 2048])
def test_plain_equals_the_former_chain_bit_for_bit(dtype, with_delta, h):
    x, delta, weight = _operands(37, h, dtype, seed=h)
    delta = delta if with_delta else None
    want_x, want_y = _former_chain(x, delta, weight, EPS)
    for fn in (rn.add_rms_norm_plain, rn.add_rms_norm):  # a CPU tensor takes the plain one
        before = rn.launches
        got_x, got_y = fn(x, delta, weight, EPS)
        assert rn.launches == before
        assert got_x.dtype == got_y.dtype == dtype
        assert torch.equal(got_x, want_x) and torch.equal(got_y, want_y)
    if delta is None:
        assert rn.add_rms_norm(x, None, weight, EPS)[0] is x


def test_rms_norm_module_is_the_plain_norm():
    x, _, weight = _operands(5, 64, torch.bfloat16)
    norm = RMSNorm(64, EPS, torch.bfloat16, param_dtype=torch.bfloat16)
    with torch.no_grad():
        norm.weight.copy_(weight)
    assert torch.equal(norm(x), rn.add_rms_norm_plain(x, None, weight, EPS)[1])


@pytest.mark.parametrize("h", [1, 32, 100, 1024, 2048, 3000, 8192])
def test_schedule_covers_the_row(h):
    block, warps = rn.schedule(h)
    assert block >= h and block < 2 * h + 1 and block & (block - 1) == 0
    assert 1 <= warps <= 16 and warps & (warps - 1) == 0


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,match", [
    ("device", "no add_rms_norm kernel for device meta"),
    ("dtype", "bf16 or f32"),
    ("strided", "contiguous"),
    ("wide", "columns"),
    ("mixed_devices", "share one device"),
    ("delta_shape", "delta must match"),
    ("delta_dtype", "delta must match"),
    ("weight_shape", "weight must be"),
])
def test_wrapper_refuses_what_the_kernel_cannot_take(case, match):
    """Every check a CUDA tensor meets before the launch, on ``meta``
    tensors (the device check comes last, so each other check is reached)."""
    x, delta, w = _meta(6, 64), _meta(6, 64), _meta(64)
    if case == "dtype":
        x, delta = _meta(6, 64, dtype=torch.float16), _meta(6, 64, dtype=torch.float16)
    elif case == "strided":
        x, delta = _meta(64, 6).t(), _meta(64, 6).t()
    elif case == "wide":
        x, delta, w = _meta(2, 16384), _meta(2, 16384), _meta(16384)
    elif case == "mixed_devices":
        w = torch.ones(64, dtype=torch.bfloat16)
    elif case == "delta_shape":
        delta = _meta(6, 32)
    elif case == "delta_dtype":
        delta = _meta(6, 64, dtype=torch.float32)
    elif case == "weight_shape":
        w = _meta(32)
    before = rn.launches
    with pytest.raises(ValueError, match=match):
        rn.add_rms_norm(x, delta, w, EPS)
    assert rn.launches == before


# -- the decoder loops against the former per-module loop --------------------------


def _former_qwen3_trunk(model, ids, ctx):
    cfg = model.cfg
    x = model.embed_tokens(ids.long()).to(cfg.dtype)
    for layer in model.layers:
        x = x + layer.self_attn(layer.input_layernorm(x), ctx)
        gu = cast_linear(layer.gateup_proj, layer.post_attention_layernorm(x), cfg.dtype)
        gate, up = gu[..., : cfg.intermediate_size], gu[..., cfg.intermediate_size:]
        x = x + cast_linear(layer.down_proj, F.silu(gate) * up, cfg.dtype)
    return x


def _former_lfm2_trunk(model, ids, ctx):
    x = model.embed_tokens(ids.long()).to(model.cfg.dtype)
    for layer in model.layers:
        h = layer.operator_norm(x)
        x = x + (layer.self_attn(h, ctx.attn) if hasattr(layer, "self_attn")
                 else layer.conv(h, ctx))
        x = x + layer.feed_forward(layer.ffn_norm(x), ctx)
    return x


class _Former:
    """The former entry points: the trunk's sum, then the final norm
    module over all rows or over the packed sequences' last rows."""

    def __init__(self, model):
        self.model = model
        if isinstance(model, qwen3.Qwen3LM):
            self.trunk, self.norm = _former_qwen3_trunk, model.norm
            self.ctx = lambda mask: qwen3.attention_context(model.cfg, mask)
            self.packed_ctx = lambda pos, seg: qwen3.packed_attention_context(
                model.cfg, pos, seg)
        else:
            self.trunk, self.norm = _former_lfm2_trunk, model.embedding_norm
            self.ctx, self.packed_ctx = model._context, model._packed_context

    def hidden(self, ids, mask):
        return self.norm(self.trunk(self.model, ids, self.ctx(mask.bool())))

    def last_logits(self, ids, mask):
        return self.model._logits(self.hidden(ids, mask)[:, -1, :])

    def last_logits_packed(self, ids, positions, seg, last_index):
        x = self.trunk(self.model, ids, self.packed_ctx(positions.long(), seg))
        return self.model._logits(self.norm(x.reshape(-1, x.shape[-1]).index_select(
            0, last_index)))


def _tiny(kind, attn_impl):
    if kind == "qwen3":
        model = init_qwen3(Qwen3Config.tiny(attn_impl=attn_impl), seed=0, device="cpu")
    else:
        model = init_lfm2_moe(Lfm2MoeConfig.tiny(attn_impl=attn_impl), seed=0, device="cpu")
    with torch.no_grad():  # weights large enough that every layer moves the logits
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                p.copy_(1 + 0.2 * torch.randn(p.shape, generator=torch.Generator()
                                              .manual_seed(len(name))))
            else:
                p.mul_(10.0)
    return model


def _left_padded(lengths, vocab=128, seed=3):
    rng = np.random.default_rng(seed)
    length = max(lengths)
    ids = np.zeros((len(lengths), length), dtype=np.int64)
    mask = np.zeros((len(lengths), length), dtype=bool)
    for i, n in enumerate(lengths):
        ids[i, length - n:] = rng.integers(4, vocab, n)
        mask[i, length - n:] = True
    return ids, mask


@pytest.mark.parametrize("attn_impl", ["auto", "einsum"])
@pytest.mark.parametrize("kind", ["qwen3", "lfm2"])
@pytest.mark.parametrize("entry", ["hidden", "last_logits", "last_logits_packed"])
def test_decoder_equals_the_former_per_module_loop(kind, attn_impl, entry):
    model = _tiny(kind, attn_impl)
    former = _Former(model)
    ids, mask = _left_padded((30, 7, 19, 1, 26))
    before = rn.launches
    with torch.no_grad():
        if entry == "last_logits_packed":
            rows, _, last = pack_prompts(ids, mask, 32)
            assert rows.shape[1] < len(ids)  # several sequences share a row
            args = [torch.from_numpy(a) for a in (*rows, last)]
        else:
            args = [torch.from_numpy(ids), torch.from_numpy(mask)]
        got = getattr(model, entry)(*args)
        want = getattr(former, entry)(*args)
    assert rn.launches == before
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    assert float(want.abs().max()) > 0.1
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("attn_impl,calls_a_layer", [("auto", 2), ("einsum", 0)])
@pytest.mark.parametrize("kind", ["qwen3", "lfm2"])
def test_every_norm_site_goes_through_qwen3s_wrappable_name(kind, attn_impl, calls_a_layer,
                                                            monkeypatch):
    """A harness wraps ``models/decoder.py``'s ``add_rms_norm`` and reaches
    every norm site of both decoders on the kernel path: 2·L + 1 calls a
    packed forward, the first with no delta; the einsum path never calls
    it."""
    model = _tiny(kind, attn_impl)
    seen = []

    def counting(x, delta, weight, eps, scale):
        seen.append(delta is None)
        return rn.add_rms_norm(x, delta, weight, eps, scale)

    monkeypatch.setattr(decoder, "add_rms_norm", counting)
    ids, mask = _left_padded((12, 5, 9))
    rows, _, last = pack_prompts(ids, mask, 16)
    with torch.no_grad():
        model.last_logits_packed(*[torch.from_numpy(a) for a in (*rows, last)])
    layers = model.cfg.num_hidden_layers
    assert len(seen) == (calls_a_layer * layers + 1 if calls_a_layer else 0)
    assert seen[:1] == ([True] if calls_a_layer else []) and not any(seen[1:])


def test_layer_hands_its_feed_forward_output_to_the_next_norm():
    """Layer 0 gets no delta; each layer returns the stream with its mixer
    added and its MLP output apart; the stream plus that output is the
    former layer's result."""
    model = _tiny("qwen3", "auto")
    ids, mask = _left_padded((9, 4))
    ctx = qwen3.attention_context(model.cfg, torch.from_numpy(mask))
    with torch.no_grad():
        x0 = model.embed_tokens(torch.from_numpy(ids))
        layer = model.layers[0]
        x1, d1 = layer(x0, None, ctx)
        h = layer.input_layernorm(x0)
        assert torch.equal(x1, x0 + layer.self_attn(h, ctx))
        former = _former_qwen3_trunk(model, torch.from_numpy(ids), ctx)
        x, delta = model._trunk(torch.from_numpy(ids), ctx)
        assert torch.equal(x + delta, former)


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Triton kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _within_one_step(got, want):
    """bf16 y: equal on at least 99.9% of elements, one step of the output
    dtype elsewhere (two f32 sums in another order straddling a rounding
    boundary); a step at |v| is at most |v| · 2^-7 in bf16."""
    g, w = got.float(), want.float()
    equal = (g == w).float().mean().item()
    assert equal >= 0.999, f"only {equal:.5f} of y bit-equal"
    assert bool(((g - w).abs() <= w.abs() * 2.0 ** -7).all())


@pytest.mark.gpu
@pytest.mark.parametrize("t,h", [(15360, 1024), (14336, 2048), (15361, 1024), (37, 32),
                                 (999, 3000)])
@pytest.mark.parametrize("with_delta", [True, False])
def test_kernel_matches_plain(cuda, t, h, with_delta):
    x, delta, weight = (a.to(cuda) for a in _operands(t, h, torch.bfloat16, seed=t))
    delta = delta if with_delta else None
    before = rn.launches
    got_x, got_y = rn.add_rms_norm(x, delta, weight, EPS)
    assert rn.launches == before + 1
    want_x, want_y = rn.add_rms_norm_plain(x, delta, weight, EPS)
    assert torch.equal(got_x, want_x)  # the residual stream: torch's bf16 add, bit for bit
    if delta is None:
        assert got_x is x
    _within_one_step(got_y, want_y)


@pytest.mark.gpu
def test_kernel_in_f32(cuda):
    x, delta, weight = (a.to(cuda) for a in _operands(513, 1024, torch.float32))
    got_x, got_y = rn.add_rms_norm(x, delta, weight, EPS)
    want_x, want_y = rn.add_rms_norm_plain(x, delta, weight, EPS)
    assert torch.equal(got_x, want_x)
    # f32 throughout: the sum of 1,024 squares in another order, a few ulps
    torch.testing.assert_close(got_y, want_y, atol=0, rtol=2e-6)


def _card_model(kind, dtype, device):
    if kind == "qwen3":
        cfg = Qwen3Config(vocab_size=1000, hidden_size=256, intermediate_size=512,
                          num_hidden_layers=28, num_attention_heads=4, num_key_value_heads=2,
                          head_dim=64, dtype=dtype, param_dtype=dtype)
        return init_qwen3(cfg, seed=0, device=device)
    cfg = Lfm2MoeConfig(vocab_size=1000, hidden_size=256, intermediate_size=512,
                        moe_intermediate_size=128, num_attention_heads=4,
                        num_key_value_heads=2, num_experts=8, num_experts_per_tok=2,
                        dtype=dtype, param_dtype=dtype)
    return init_lfm2_moe(cfg, seed=0, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,dtype", [("qwen3", torch.bfloat16), ("qwen3", torch.float32),
                                        ("lfm2", torch.bfloat16)])
def test_packed_forward_launches_once_a_norm_site_without_host_sync(cuda, kind, dtype,
                                                                    monkeypatch):
    """A packed forward at the served depth (28 Qwen3 layers, 24 LFM2
    layers): one launch a norm site, 2·L + 1, no host sync; the logits
    against the same forward with the plain chain in place of the kernel
    (LFM2 only in bf16: its expert GEMMs take no f32 on the card)."""
    model = _card_model(kind, dtype, cuda)
    ids, mask = _left_padded((130, 7, 61, 250, 33, 90), vocab=1000)
    rows, _, last = pack_prompts(ids, mask, 256)
    args = [torch.from_numpy(a).to(cuda) for a in (*rows, last)]
    with torch.no_grad():
        model.last_logits_packed(*args)  # builds the kernels
        torch.cuda.synchronize()
        before = rn.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = model.last_logits_packed(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert rn.launches - before == 2 * model.cfg.num_hidden_layers + 1
        # both decoders reach the op through decoder.residual_norm
        monkeypatch.setattr(decoder, "add_rms_norm", rn.add_rms_norm_plain)
        want = model.last_logits_packed(*args)
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) < 1e-4
    else:
        # one bf16 step on a few elements of some norms, carried through the
        # stack (LFM2: a near-tie in the router may then choose apart)
        assert float(err.max()) < 0.1 and float(err.mean()) < 0.01
