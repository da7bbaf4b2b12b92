"""The slice as a whole on the CPU: ``TorchVectorStore`` over
``TorchEncoderEmbeddings`` against ``TPUVectorStore`` over
``FlaxEncoderEmbeddings``, on the same Flax params (through the weight
bridge) and the same texts, must return the same Document ids from
``batch_similarity_search_with_score`` and ``as_retriever().invoke``.
f32 encoders; scores within 1e-5.

Also: the port's modules import without JAX (checked in a subprocess,
since this suite's conftest imports JAX), and ``chip_smoke.py`` imports
neither JAX nor the JAX package and refuses to run without a card."""

import ast
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_arc_tpu.index.vector_store import TPUVectorStore
from rag_arc_tpu.models import encoder as fenc
from rag_arc_tpu.models.flax_embeddings import FlaxEncoderEmbeddings
from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
from rag_arc_tpu_torch.models import encoder as tenc
from rag_arc_tpu_torch.models.convert import encoder_state_dict_from_flax
from rag_arc_tpu_torch.models.torch_embeddings import TorchEncoderEmbeddings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _texts(seed, n):
    rng = np.random.default_rng(seed)
    vocab = ["".join(rng.choice(list("abcdefghij"), int(rng.integers(3, 7)))) for _ in range(400)]
    lens = rng.integers(3, 90, n)  # long documents take the bucketed path
    return [" ".join(rng.choice(vocab, int(m))) for m in lens]


@pytest.fixture(scope="module")
def stores():
    fcfg = fenc.TransformerConfig.tiny(dtype=jnp.float32, max_len=128)
    tcfg = tenc.TransformerConfig.tiny(dtype=torch.float32, max_len=128)
    _, params = fenc.init_encoder(fcfg, seed=3)
    params = jax.tree_util.tree_map(np.asarray, params)
    texts = _texts(0, 120)
    ids = [f"d{i}" for i in range(len(texts))]
    # TPUVectorStore.from_texts passes no ids through: add them explicitly
    jstore = TPUVectorStore(FlaxEncoderEmbeddings(fcfg, params=params), capacity=2048)
    jstore.add_texts(texts, ids=ids)
    temb = TorchEncoderEmbeddings(
        tcfg, state_dict=encoder_state_dict_from_flax(params), device="cpu"
    )
    tstore = TorchVectorStore.from_texts(texts, temb, ids=ids, capacity=2048, device="cpu")
    return jstore, tstore, texts


def _ids(results):
    return [[d.id for d, _ in hits] for hits in results]


@pytest.mark.parametrize("two_level", [False, True])
def test_batch_search_same_documents(stores, two_level):
    jstore, tstore, texts = stores
    tstore.index._force_two_level = two_level
    try:
        queries = texts[:9] + ["abc def", "nothing like the corpus"]
        want = jstore.batch_similarity_search_with_score(queries, k=5)
        got = tstore.batch_similarity_search_with_score(queries, k=5)
    finally:
        tstore.index._force_two_level = False
    assert _ids(got) == _ids(want)
    np.testing.assert_allclose(
        [[s for _, s in h] for h in got], [[s for _, s in h] for h in want],
        rtol=0, atol=1e-5,
    )
    assert all(hits[0][0].id == f"d{i}" for i, hits in enumerate(got[:9]))


def test_retriever_invoke_same_documents(stores):
    jstore, tstore, texts = stores
    jr = jstore.as_retriever(search_kwargs={"k": 4})
    tr = tstore.as_retriever(search_kwargs={"k": 4})
    for q in texts[10:16]:
        got = tr.invoke(q)
        assert [d.id for d in got] == [d.id for d in jr.invoke(q)]
        assert all(tstore.get_by_ids([d.id])[0] is d for d in got)


def test_delete_compact_then_search(stores):
    jstore, tstore, texts = stores
    for store in (jstore, tstore):
        # 61 of 120 deleted: past compact_threshold 0.5, so both compact
        store.delete([f"d{i}" for i in range(0, 120, 2)] + ["d1"])
    assert tstore.index.n_deleted == jstore.index.n_deleted == 0
    queries = texts[:6]
    assert _ids(tstore.batch_similarity_search_with_score(queries, k=3)) == _ids(
        jstore.batch_similarity_search_with_score(queries, k=3)
    )


def test_unported_search_types_raise(stores):
    # MMR and multi_query_search are both ported now: each answers. With
    # random encoder weights the candidates are near-duplicates, so MMR's
    # diversity term turns on 1e-6 differences: it is held to the host
    # selection over the store's own candidates here, and to the JAX
    # store's ids on hash embeddings in tests/test_torch_mmr.py
    from rag_arc_tpu_torch.ops.mmr import mmr_select

    jstore, tstore, texts = stores
    got = tstore.max_marginal_relevance_search(texts[0], k=4, fetch_k=12)
    q = tstore.embedding.encode([texts[0]])
    _, pos = tstore.index.search(q, 12)
    chosen = mmr_select(q[0], tstore.index.take(pos[0]), k=4)
    want = [tstore.docstore.get_by_position(int(pos[0][i])).id for i in chosen]
    assert len(got) == 4 and [d.id for d in got] == want
    assert got[0].id == jstore.max_marginal_relevance_search(texts[0], k=1)[0].id
    hits = tstore.multi_query_search([["abc"]], k=3)
    assert len(hits) == 1 and len(hits[0]) == 3


def test_port_imports_without_jax():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import rag_arc_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            rag_arc_tpu_torch.__path__, "rag_arc_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert len(names) >= 70, names
        for name in ("rag_arc_tpu_torch.index.persistence",
                     "rag_arc_tpu_torch.ops.subtile_max_i8",
                     "rag_arc_tpu_torch.rerank.base",
                     "rag_arc_tpu_torch.rerank.cross_encoder",
                     "rag_arc_tpu_torch.models.qwen3",
                     "rag_arc_tpu_torch.ops.rope_prep",
                     "rag_arc_tpu_torch.ops.flash_attention",
                     "rag_arc_tpu_torch.ops.subtile_max_piped",
                     "rag_arc_tpu_torch.ops.fused_mips",
                     "rag_arc_tpu_torch.ops.corpus_stream",
                     "rag_arc_tpu_torch.tools.kernel_probe",
                     "rag_arc_tpu_torch.utils.data_model",
                     "rag_arc_tpu_torch.utils.locks",
                     "rag_arc_tpu_torch.utils.tracing",
                     "rag_arc_tpu_torch.models.embeddings",
                     "rag_arc_tpu_torch.models.packing",
                     "rag_arc_tpu_torch.models.tokenizer",
                     "rag_arc_tpu_torch.utils.transfers",
                     "rag_arc_tpu_torch.utils.fusion",
                     "rag_arc_tpu_torch.native.build",
                     "rag_arc_tpu_torch.ops.bm25",
                     "rag_arc_tpu_torch.ops.fusion_kernel",
                     "rag_arc_tpu_torch.index.bm25",
                     "rag_arc_tpu_torch.retrieval.bm25",
                     "rag_arc_tpu_torch.retrieval.multipath",
                     "rag_arc_tpu_torch.tools.bm25_synth",
                     "rag_arc_tpu_torch.ops.mmr",
                     "rag_arc_tpu_torch.index.blob_docstore",
                     "rag_arc_tpu_torch.serving.batcher",
                     "rag_arc_tpu_torch.serving.pipeline",
                     "rag_arc_tpu_torch.serving.configs",
                     "rag_arc_tpu_torch.serving.app",
                     "rag_arc_tpu_torch.llm.base",
                     "rag_arc_tpu_torch.llm.fake",
                     "rag_arc_tpu_torch.llm.openai_compat",
                     "rag_arc_tpu_torch.retrieval.rewrite",
                     "rag_arc_tpu_torch.framework.config",
                     "rag_arc_tpu_torch.framework.module",
                     "rag_arc_tpu_torch.framework.registry",
                     "rag_arc_tpu_torch.chunking.splitters",
                     "rag_arc_tpu_torch.parsing.base",
                     "rag_arc_tpu_torch.parsing.text_parser",
                     "rag_arc_tpu_torch.parsing.docx_parser",
                     "rag_arc_tpu_torch.parsing.xlsx_parser",
                     "rag_arc_tpu_torch.parsing.pptx_parser",
                     "rag_arc_tpu_torch.parsing.html_parser",
                     "rag_arc_tpu_torch.parsing.multi",
                     "rag_arc_tpu_torch.tools.ingest",
                     "rag_arc_tpu_torch.ops.kmeans",
                     "rag_arc_tpu_torch.ops.ivf_scan",
                     "rag_arc_tpu_torch.index.ivf",
                     "rag_arc_tpu_torch.index.hnsw",
                     "rag_arc_tpu_torch.tools.ivf_oracle"):
            assert name in names, name
        bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "flax")))
        assert not bad, bad
        # nor anything of the JAX package, not even its host-only modules
        bad = sorted(m for m in sys.modules
                     if m == "rag_arc_tpu" or m.startswith("rag_arc_tpu."))
        assert not bad, bad
        print("ok", len(names))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=False,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_names_only_the_port():
    # the smoke runs where neither JAX nor the JAX package is installed
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "rag_arc_tpu_torch.index.vector_store" in names
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "rag_arc_tpu")]
    assert not bad, bad


def test_chip_smoke_refuses_without_a_card(tmp_path):
    # with no card visible the smoke must fail and print no result, both in
    # the repo and alone in an empty directory
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO), (str(alone), tmp_path)):
        out = subprocess.run(
            [sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True,
            timeout=120, check=False,
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
