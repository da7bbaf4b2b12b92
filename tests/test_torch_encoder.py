"""Parity of the port's encoder with the Flax one on the CPU: Flax params go
through ``encoder_state_dict_from_flax`` into the port, and both forwards
run on the same token ids. At f32 outputs match to 1e-5; at bf16 (where
the two frameworks round at different places) the row cosine is
≥ 0.999."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_arc_tpu.models import encoder as fenc
from rag_arc_tpu.models.packing import pack_token_lists
from rag_arc_tpu_torch.models import encoder as tenc
from rag_arc_tpu_torch.models.convert import encoder_state_dict_from_flax

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(dtype, seed=0):
    jdt, tdt = DTYPES[dtype]
    fcfg = fenc.TransformerConfig.tiny(dtype=jdt)
    tcfg = tenc.TransformerConfig.tiny(dtype=tdt)
    _, params = fenc.init_encoder(fcfg, seed=seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    model = tenc.TextEncoder(tcfg)
    model.load_state_dict(encoder_state_dict_from_flax(params))
    return fcfg, params, model.eval()


def _batch(seed, b=5, length=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 512, (b, length)).astype(np.int32)
    lens = rng.integers(1, length + 1, b)
    lens[0] = length
    mask = np.arange(length)[None, :] < lens[:, None]
    ids[~mask] = 0
    return ids, mask


def _cos(a, b):
    return (a * b).sum(-1) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-12
    )


def test_state_dict_covers_every_parameter():
    _, params, model = _models("f32")
    sd = encoder_state_dict_from_flax(params)
    assert set(sd) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert sd[name].shape == t.shape, name


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_text_encoder_matches_flax(dtype):
    fcfg, params, model = _models(dtype)
    ids, mask = _batch(1)
    want = np.asarray(fenc.TextEncoder(fcfg).apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert _cos(got, want).min() >= 0.999


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_encoder_matches_flax(dtype):
    fcfg, params, model = _models(dtype, seed=1)
    rng = np.random.default_rng(2)
    lists = [rng.integers(4, 512, int(n)).tolist() for n in rng.integers(0, 40, 11)]
    ids, pos, seg, _ = pack_token_lists(lists, row_len=64, max_segments=4)
    want = np.asarray(
        fenc.PackedTextEncoder(fcfg, max_segments=4).apply(
            params, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(seg)
        )
    )
    packed = tenc.PackedTextEncoder(model.cfg, max_segments=4, trunk=model.trunk)
    with torch.no_grad():
        got = packed(*(torch.from_numpy(a).long() for a in (ids, pos, seg))).numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        live = np.linalg.norm(want, axis=-1) > 0
        assert _cos(got, want)[live].min() >= 0.999
        assert not got[~live].any()


def test_packed_matches_unpacked():
    """The port's packed forward equals its unpacked one per document."""
    _, _, model = _models("f32", seed=3)
    rng = np.random.default_rng(4)
    lists = [rng.integers(4, 512, int(n)).tolist() for n in rng.integers(1, 30, 9)]
    ids, pos, seg, mapping = pack_token_lists(lists, row_len=64, max_segments=4)
    packed = tenc.PackedTextEncoder(model.cfg, max_segments=4, trunk=model.trunk)
    with torch.no_grad():
        out = packed(*(torch.from_numpy(a).long() for a in (ids, pos, seg)))
        for i, tl in enumerate(lists):
            single = model(torch.tensor([tl]), torch.ones(1, len(tl), dtype=torch.bool))
            r, s = mapping[i]
            torch.testing.assert_close(out[r, s], single[0], atol=1e-5, rtol=0)


def test_init_is_seeded_and_scaled():
    cfg = tenc.TransformerConfig.tiny(dtype=torch.float32)
    a = tenc.init_encoder(cfg, 7, "cpu").state_dict()
    b = tenc.init_encoder(cfg, 7, "cpu").state_dict()
    c = tenc.init_encoder(cfg, 8, "cpu").state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["trunk.blocks.0.qkv.weight"], c["trunk.blocks.0.qkv.weight"])
    w = a["trunk.blocks.0.mlp_up.weight"]
    assert abs(float(w.std()) - cfg.dim ** -0.5) < 0.1 * cfg.dim ** -0.5
    assert float(w.abs().max()) <= 2 * cfg.dim ** -0.5 / 0.87962566103423978 + 1e-6


def test_fast_encoder_state_dict_is_text_encoders():
    cfg = tenc.TransformerConfig.tiny(dtype=torch.float32)
    fast = tenc.TextEncoderFast(cfg, device="cpu")
    assert set(fast.state_dict()) == set(tenc.TextEncoder(cfg).state_dict())
    _, params, _ = _models("f32")
    fast.load_state_dict(encoder_state_dict_from_flax(params))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fast_encoder_matches_flax_fast(dtype):
    """The port's TextEncoderFast against the Flax TextEncoderFast on the
    same weights: 1e-5 at f32, row cosine >= 0.999 at bf16."""
    fcfg, params, model = _models(dtype, seed=5)
    fast = tenc.TextEncoderFast(model.cfg, device="cpu")
    fast.load_state_dict(model.state_dict())
    ids, mask = _batch(6)
    want = np.asarray(fenc.TextEncoderFast(fcfg).apply(params, jnp.asarray(ids),
                                                       jnp.asarray(mask)))
    with torch.no_grad():
        got = fast.eval()(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert _cos(got, want).min() >= 0.999


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fast_encoder_matches_text_encoder(dtype):
    """TextEncoderFast against the port's TextEncoder on the same weights:
    1e-5 at f32; at bf16 within the reference's ~1e-2 relative (rounding
    only)."""
    _, _, model = _models(dtype, seed=7)
    fast = tenc.TextEncoderFast(model.cfg, device="cpu")
    fast.load_state_dict(model.state_dict())
    ids, mask = _batch(8)
    with torch.no_grad():
        want = model(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
        got = fast.eval()(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        rel = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
        assert rel.max() <= 1e-2
