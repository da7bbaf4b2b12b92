"""The port's BERT against HF's ``BertModel`` and the JAX package's
``FlaxBertModel`` on the CPU, from random-init models the tests build (no
download): an HF state_dict loads into the port as it is, Flax params come
across through ``bert_state_dict_from_flax``; live rows of the last hidden
state and the pooler agree within 2e-4 (f32). Then the sentence-embedding
adapters: ``BertEmbeddings`` end to end, ``load_hf_bert`` from a saved
checkpoint, and ``SentenceTransformerEmbeddings``' missing-package error
and passthrough on a stub model."""

import sys
import types

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rag_arc_tpu.models.bert import BertConfig as JaxBertConfig  # noqa: E402
from rag_arc_tpu.models.bert import FlaxBertModel, convert_torch_bert  # noqa: E402
from rag_arc_tpu_torch.models.bert import (  # noqa: E402
    BertConfig,
    BertEmbeddings,
    BertModel,
    init_bert,
    load_hf_bert,
)
from rag_arc_tpu_torch.models.convert import bert_state_dict_from_flax  # noqa: E402

TOL = 2e-4


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    hf_cfg = transformers.BertConfig(
        vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    )
    hf = transformers.BertModel(hf_cfg).eval()
    port = BertModel(BertConfig.tiny(), device="cpu").eval()
    port.load_state_dict(hf.state_dict())  # HF names: no renaming
    flax_model = FlaxBertModel(JaxBertConfig.tiny())
    params = convert_torch_bert(hf.state_dict(), JaxBertConfig.tiny())
    return hf, port, flax_model, params


def _batch(seed=0, b=3, length=10):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, (b, length)).astype(np.int64)
    mask = np.ones((b, length), dtype=bool)
    mask[1, 7:] = False
    mask[2, 4:] = False
    types_ = (np.arange(length)[None, :] >= length // 2).astype(np.int64).repeat(b, 0)
    return ids, mask, types_


def _port(model, ids, mask, types_=None):
    with torch.no_grad():
        h, p = model(torch.from_numpy(ids), torch.from_numpy(mask),
                     None if types_ is None else torch.from_numpy(types_))
    return h.numpy(), p.numpy()


def test_state_dict_names_are_hf(models):
    hf, port, _, params = models
    assert set(port.state_dict()) == set(hf.state_dict())
    sd = bert_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    assert set(sd) == set(port.state_dict())
    for name, t in port.state_dict().items():
        assert sd[name].shape == t.shape, name
        np.testing.assert_array_equal(sd[name].numpy(), hf.state_dict()[name].numpy())


@pytest.mark.parametrize("with_types", [False, True])
def test_hidden_and_pooler_match_hf(models, with_types):
    hf, port, _, _ = models
    ids, mask, types_ = _batch()
    types_ = types_ if with_types else None
    with torch.no_grad():
        out = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask).long(),
                 token_type_ids=None if types_ is None else torch.from_numpy(types_))
    h, p = _port(port, ids, mask, types_)
    np.testing.assert_allclose(h[mask], out.last_hidden_state.numpy()[mask], atol=TOL)
    np.testing.assert_allclose(p, out.pooler_output.numpy(), atol=TOL)


@pytest.mark.parametrize("source", ["converted", "flax_init"])
def test_hidden_and_pooler_match_flax(models, source):
    _, _, flax_model, params = models
    ids, mask, types_ = _batch(1)
    if source == "flax_init":
        params = flax_model.init(jax.random.PRNGKey(3), jnp.asarray(ids, jnp.int32),
                                 jnp.asarray(mask))
    port = BertModel(BertConfig.tiny(), device="cpu").eval()
    port.load_state_dict(bert_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    want_h, want_p = flax_model.apply(params, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
                                      jnp.asarray(types_, jnp.int32))
    h, p = _port(port, ids, mask, types_)
    np.testing.assert_allclose(h[mask], np.asarray(want_h)[mask], atol=TOL)
    np.testing.assert_allclose(p, np.asarray(want_p), atol=TOL)
    emb = port.mean_pooled(torch.from_numpy(ids), torch.from_numpy(mask)).detach().numpy()
    want = flax_model.mean_pooled(params, jnp.asarray(ids, jnp.int32), jnp.asarray(mask))
    np.testing.assert_allclose(emb, np.asarray(want), atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, rtol=1e-5)


def test_init_is_seeded():
    cfg = BertConfig.tiny()
    a, b, c = (init_bert(cfg, s, "cpu").state_dict() for s in (5, 5, 6))
    assert all(torch.equal(a[n], b[n]) for n in a)
    w = "encoder.layer.0.attention.self.query.weight"
    assert not torch.equal(a[w], c[w])
    assert abs(float(a[w].std()) - 0.02) < 0.005


def test_bert_embeddings_end_to_end(models):
    from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
    from rag_arc_tpu_torch.models.tokenizer import HashTokenizer

    _, port, _, _ = models
    emb = BertEmbeddings(port, HashTokenizer(vocab_size=128, max_len=32), batch_size=2)
    texts = ["cats purr", "bonds yield", "cats nap"]
    vecs = emb.encode(texts)
    assert vecs.shape == (3, 32) and np.allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-5)
    # no batch padding: a text's vector is the same alone or in a batch
    np.testing.assert_allclose(emb.encode(["bonds yield"])[0], vecs[1], atol=1e-6)
    store = TorchVectorStore.from_texts(texts, emb, device="cpu")
    assert store.similarity_search("cats purr", k=1)[0].content == "cats purr"


def test_load_hf_bert_from_a_saved_checkpoint(models, tmp_path):
    hf, port, _, _ = models
    hf.save_pretrained(tmp_path)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "cats", "purr", "bonds", "yield"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    transformers.BertTokenizer(str(tmp_path / "vocab.txt")).save_pretrained(tmp_path)
    model, sd, tok = load_hf_bert(str(tmp_path), device="cpu")
    assert set(sd) == set(port.state_dict())
    ids, mask, _ = _batch(2)
    np.testing.assert_array_equal(_port(model, ids, mask)[0], _port(port, ids, mask)[0])
    emb = BertEmbeddings(model, tok).encode(["cats purr", "bonds yield"])
    assert emb.shape == (2, 32)


# -- sentence-transformers adapter ------------------------------------------------------


def test_sentence_transformers_missing_package(monkeypatch):
    from rag_arc_tpu_torch.models.st_embeddings import SentenceTransformerEmbeddings

    monkeypatch.setitem(sys.modules, "sentence_transformers", None)
    with pytest.raises(ImportError, match="sentence-transformers is not installed"):
        SentenceTransformerEmbeddings("/nowhere", device="cpu")


def test_sentence_transformers_passthrough(monkeypatch):
    from rag_arc_tpu_torch.models.embeddings import Embeddings
    from rag_arc_tpu_torch.models.st_embeddings import SentenceTransformerEmbeddings

    seen = {}

    class StubModel:
        def __init__(self, path, **kw):
            seen["init"] = (path, kw)

        def get_sentence_embedding_dimension(self):
            return 4

        def encode(self, texts, **kw):
            seen["encode"] = (list(texts), kw)
            return np.arange(4 * len(texts), dtype=np.float64).reshape(len(texts), 4)

    monkeypatch.setitem(sys.modules, "sentence_transformers",
                        types.SimpleNamespace(SentenceTransformer=StubModel))
    emb = SentenceTransformerEmbeddings("/ckpt", model_kwargs={"trust_remote_code": False},
                                        encode_kwargs={"batch_size": 8}, device="cpu")
    assert isinstance(emb, Embeddings) and emb.dim == 4
    assert seen["init"] == ("/ckpt", {"trust_remote_code": False, "device": "cpu"})
    out = emb.encode(["a\nb", "c"])
    assert out.dtype == np.float32 and out.shape == (2, 4)
    assert seen["encode"] == (["a b", "c"], {"convert_to_numpy": True, "batch_size": 8,
                                             "normalize_embeddings": True})
    assert emb.encode([]).shape == (0, 4)
    assert emb.embed_documents(["c"]) == [[0.0, 1.0, 2.0, 3.0]]
    assert emb.embed_query("c") == [0.0, 1.0, 2.0, 3.0]
