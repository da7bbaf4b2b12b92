"""Parity of the port's Qwen3 with the JAX package and with HF torch on the
CPU. Flax params go through ``qwen3_state_dict_from_flax``, an HF
``Qwen3ForCausalLM`` (random init, no downloads) through
``qwen3_state_dict_from_hf``; the same token ids, made from a seed, go
into every model.

Tolerances: f32 port against Flax 1e-5 (summation order only); against HF
3e-4 (the JAX package's own bar against HF, tests/test_qwen3.py); bf16
port against the bf16 Flax einsum path 5e-2 on logits of magnitude ~3
(a few bf16 ulps: the two frameworks round bf16 at different places)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from rag_arc_tpu.models import qwen3 as fq  # noqa: E402
from rag_arc_tpu.models.tokenizer import HashTokenizer  # noqa: E402
from rag_arc_tpu_torch.models import qwen3 as tq  # noqa: E402
from rag_arc_tpu_torch.models.convert import (  # noqa: E402
    qwen3_state_dict_from_flax,
    qwen3_state_dict_from_hf,
)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flax(seed=0, **kw):
    cfg = fq.Qwen3Config.tiny(**kw)
    model = fq.FlaxQwen3LM(cfg)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(seed), ids, jnp.ones((1, 8), bool))
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port(params, **kw):
    model = tq.Qwen3LM(tq.Qwen3Config.tiny(**kw))
    model.load_state_dict(qwen3_state_dict_from_flax(params))
    return model.eval()


def _batch(seed, b=4, length=24, vocab=128, full=False):
    """Left-padded rows (the reranker's layout); row 0 unpadded."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, (b, length)).astype(np.int32)
    live = rng.integers(1, length + 1, b)
    live[0] = length
    if full:
        live[:] = length
    mask = np.arange(length)[None, :] >= (length - live)[:, None]
    ids[~mask] = 0
    return ids, mask


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("tied", [False, True])
def test_state_dict_covers_every_parameter(tied):
    _, params = _flax(tie_word_embeddings=tied)
    sd = qwen3_state_dict_from_flax(params)
    model = tq.Qwen3LM(tq.Qwen3Config.tiny(tie_word_embeddings=tied))
    assert set(sd) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert sd[name].shape == t.shape, name
    assert ("lm_head.weight" in sd) is not tied


@pytest.mark.parametrize("impl", ["auto", "flash", "einsum"])
@pytest.mark.parametrize("full", [True, False])
def test_last_logits_match_flax_f32(impl, full):
    fmodel, params = _flax(seed=1)
    model = _port(params, attn_impl=impl)
    ids, mask = _batch(2, full=full)
    want = np.asarray(fmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                                   method=fmodel.last_logits))
    with torch.no_grad():
        got = model.last_logits(*_t(ids, mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "einsum"])
def test_full_logits_and_embed_match_flax_on_live_rows(impl):
    fmodel, params = _flax(seed=2)
    model = _port(params, attn_impl=impl)
    ids, mask = _batch(3)
    want = np.asarray(fmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    want_emb = np.asarray(fmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                                       method=fmodel.embed))
    with torch.no_grad():
        got = model(*_t(ids, mask)).numpy()
        emb = model.embed(*_t(ids, mask)).numpy()
    # pad positions differ by design (module docstring); nothing reads them
    np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=1e-5)
    np.testing.assert_allclose(emb, want_emb, rtol=0, atol=1e-5)


def test_einsum_bf16_matches_flax_bf16():
    fmodel, params = _flax(seed=3, dtype=jnp.bfloat16, attn_impl="einsum")
    model = _port(params, dtype=torch.bfloat16, attn_impl="einsum")
    ids, mask = _batch(4)
    want = np.asarray(fmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                                   method=fmodel.last_logits), np.float32)
    with torch.no_grad():
        got = model.last_logits(*_t(ids, mask)).float().numpy()
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)


def test_fused_bf16_close_to_einsum_bf16():
    """The kernel path's plain versions against the reference path at bf16:
    the fused path rounds once after norm + rope and rounds exp(s - max)
    before P·V, the einsum path rounds after the norm and after the
    normalized softmax. Same bound as against Flax."""
    _, params = _flax(seed=4)
    fused = _port(params, dtype=torch.bfloat16)
    ref = _port(params, dtype=torch.bfloat16, attn_impl="einsum")
    ids, mask = _batch(5)
    with torch.no_grad():
        a = fused.last_logits(*_t(ids, mask)).float()
        b = ref.last_logits(*_t(ids, mask)).float()
    torch.testing.assert_close(a, b, atol=5e-2, rtol=0)


def _packed(ids, mask, row_len):
    """The live tokens of left-padded rows, laid one after another in rows
    of ``row_len`` (in order, a new row when one is full): ids, positions,
    segment ids (−1 on padding) and each sequence's flat last index."""
    lens = mask.sum(axis=1)
    rows = []
    for i, n in enumerate(lens):
        if not rows or sum(m for _, m in rows[-1]) + n > row_len:
            rows.append([])
        rows[-1].append((i, n))
    out = np.zeros((3, len(rows), row_len), np.int32)
    out[2] = -1
    last = np.zeros(len(lens), np.int64)
    for r, members in enumerate(rows):
        col = 0
        for slot, (i, n) in enumerate(members):
            out[0, r, col : col + n] = ids[i, -n:]
            out[1, r, col : col + n] = np.arange(n)
            out[2, r, col : col + n] = slot
            last[i] = r * row_len + col + n - 1
            col += n
    return out, last


@pytest.mark.parametrize("impl", ["auto", "flash", "einsum"])
def test_last_logits_packed_match_flax_f32(impl):
    """Sequences packed several to a row read the same logits at their last
    tokens as Flax's ``last_logits`` over the left-padded batch."""
    fmodel, params = _flax(seed=6)
    model = _port(params, attn_impl=impl)
    ids, mask = _batch(7, b=7)
    want = np.asarray(fmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                                   method=fmodel.last_logits))
    rows, last = _packed(ids, mask, 48)
    assert rows.shape[1] < 7
    with torch.no_grad():
        got = model.last_logits_packed(*_t(rows[0], rows[1], rows[2], last)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def hf_model():
    hf_cfg = transformers.Qwen3Config(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        max_position_embeddings=64, rope_theta=10000.0, attention_dropout=0.0,
        tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    return transformers.Qwen3ForCausalLM(hf_cfg).eval()


@pytest.mark.parametrize("full", [True, False])
def test_hf_converter_matches_hf(hf_model, full):
    cfg = tq.Qwen3Config.tiny()
    model = tq.Qwen3LM(cfg)
    model.load_state_dict(qwen3_state_dict_from_hf(hf_model.state_dict(), cfg))
    ids, mask = _batch(6, full=full)
    position_ids = np.maximum(np.cumsum(mask, axis=1) - 1, 0)
    with torch.no_grad():
        want = hf_model(
            input_ids=torch.from_numpy(ids).long(),
            attention_mask=torch.from_numpy(mask).long(),
            position_ids=torch.from_numpy(position_ids).long(),
        ).logits.numpy()
        got = model(*_t(ids, mask)).numpy()
    np.testing.assert_allclose(got[:, -1], want[:, -1], rtol=0, atol=3e-4)
    if full:
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-4)


def test_tied_embeddings():
    hf_cfg = transformers.Qwen3Config(
        vocab_size=96, hidden_size=16, intermediate_size=32, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=1, head_dim=8,
        max_position_embeddings=32, rope_theta=10000.0, tie_word_embeddings=True,
    )
    torch.manual_seed(1)
    hf = transformers.Qwen3ForCausalLM(hf_cfg).eval()
    kw = dict(vocab_size=96, hidden_size=16, intermediate_size=32, num_hidden_layers=1,
              num_attention_heads=2, num_key_value_heads=1, head_dim=8,
              max_position_embeddings=32, tie_word_embeddings=True)
    cfg = tq.Qwen3Config.tiny(**kw)
    model = tq.Qwen3LM(cfg)
    sd = qwen3_state_dict_from_hf(hf.state_dict(), cfg)
    assert "lm_head.weight" not in sd and not hasattr(model, "lm_head")
    model.load_state_dict(sd)
    ids = (np.arange(8, dtype=np.int32)[None, :] * 7) % 96
    mask = np.ones((1, 8), bool)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids).long()).logits.numpy()
        got = model(*_t(ids, mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-4)
    # and through the Flax tree of the same tied model
    fcfg = fq.Qwen3Config.tiny(**kw)
    fparams = jax.tree_util.tree_map(np.asarray, fq.convert_torch_qwen3(hf.state_dict(), fcfg))
    flax_logits = np.asarray(fq.FlaxQwen3LM(fcfg).apply(fparams, jnp.asarray(ids),
                                                        jnp.asarray(mask)))
    port = tq.Qwen3LM(cfg)
    port.load_state_dict(qwen3_state_dict_from_flax(fparams))
    with torch.no_grad():
        np.testing.assert_allclose(port(*_t(ids, mask)).numpy(), flax_logits,
                                   rtol=0, atol=1e-5)


def test_embeddings_match_flax():
    fmodel, params = _flax(seed=5)
    model = _port(params)
    tok = HashTokenizer(vocab_size=128, max_len=32)
    texts = ["alpha beta", "gamma delta epsilon", "alpha", "a much longer text about beta"]
    want = fq.Qwen3Embeddings(fmodel, params, tok, batch_size=3).encode(texts)
    emb = tq.Qwen3Embeddings(model, tok, batch_size=3)
    got = emb.encode(texts)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    # a text's vector does not depend on what it is batched with
    alone = tq.Qwen3Embeddings(model, tok, batch_size=1).encode(texts)
    np.testing.assert_allclose(alone, got, rtol=0, atol=1e-5)
    assert np.allclose(emb.embed_query("alpha"), got[2], atol=1e-6)


def test_attn_impl_is_checked():
    with pytest.raises(ValueError, match="attn_impl"):
        tq.Qwen3Config.tiny(attn_impl="bogus")
    assert dataclasses.replace(tq.Qwen3Config(), attn_impl="flash").attn_impl == "flash"


def test_init_is_seeded_and_scaled():
    cfg = tq.Qwen3Config.tiny(param_dtype=torch.bfloat16, dtype=torch.bfloat16)
    a = tq.init_qwen3(cfg, 7, "cpu").state_dict()
    b = tq.init_qwen3(cfg, 7, "cpu").state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    w = a["layers.0.gateup_proj.weight"]
    assert w.dtype == torch.bfloat16 and abs(float(w.float().std()) - 0.02) < 2e-3
    assert torch.equal(a["layers.0.input_layernorm.weight"].float(), torch.ones(32))


def test_load_hf_qwen3_from_a_local_checkpoint(tmp_path, hf_model):
    """A saved HF checkpoint directory (weights + a word-level tokenizer
    built here) loads into the port and scores as HF does."""
    tokenizers = pytest.importorskip("tokenizers")
    vocab = {"[PAD]": 0, "[UNK]": 1, **{f"w{i}": i + 2 for i in range(100)}}
    tk = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, unk_token="[UNK]"))
    tk.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tk, pad_token="[PAD]",
                                                unk_token="[UNK]")
    hf_model.save_pretrained(tmp_path)
    fast.save_pretrained(tmp_path)
    model, state, tokenizer = tq.load_hf_qwen3(str(tmp_path), device="cpu")
    assert set(state) == set(model.state_dict())
    enc = tokenizer(["w1 w2 w3", "w4"], padding=True, return_tensors="np")
    ids = enc["input_ids"].astype(np.int32)
    mask = enc["attention_mask"].astype(bool)
    with torch.no_grad():
        want = hf_model(input_ids=torch.from_numpy(ids[:1]).long()).logits.numpy()
        got = model(*_t(ids[:1], mask[:1])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-4)
