"""The port's ingest path on the CPU, held against the JAX package.

- ``tools/ingest.py``: the same generated directory (txt, md, html, docx,
  xlsx, pptx; ``tools/doc_synth.py``) through both packages' ``ingest``
  with the hash embedder gives equal chunk texts, sources, docstore and
  BM25 snapshots (ids from one seeded sequence) and ``emb.npy`` within
  1e-6; with ``--blob-docstore`` too.
- ``BlobDocstore`` (a copy) and blob snapshots: a round trip within each
  package and across them in both directions.
- The chunkers and parsers (copies): output equal to the JAX package's.
- ``--index-type ivf|hnsw``: the same directory through both packages
  gives equal docstores and manifests, and the port's snapshot answers
  the JAX package's snapshot's ids; the CLI builds both; the port's
  refusal: ``--vlm-url``.
"""

import json
import uuid

import numpy as np
import pytest

from rag_arc_tpu.chunking import splitters as jsplit
from rag_arc_tpu.index import persistence as jpers
from rag_arc_tpu.index.blob_docstore import BlobDocstore as JaxBlob
from rag_arc_tpu.index.vector_store import TPUVectorStore
from rag_arc_tpu.models.embeddings import HashEmbeddings as JaxHash
from rag_arc_tpu.parsing import multi as jmulti
from rag_arc_tpu.tools import ingest as jingest
from rag_arc_tpu.utils.data_model import Document as JaxDocument
from rag_arc_tpu_torch.chunking import splitters as tsplit
from rag_arc_tpu_torch.index import persistence as tpers
from rag_arc_tpu_torch.index.blob_docstore import BlobDocstore
from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
from rag_arc_tpu_torch.models.embeddings import HashEmbeddings
from rag_arc_tpu_torch.parsing import multi as tmulti
from rag_arc_tpu_torch.tools import ingest as tingest
from rag_arc_tpu_torch.tools.doc_synth import FORMATS, write_corpus
from rag_arc_tpu_torch.utils.data_model import Document


class _SeededUUID:
    """Documents without ids get uuid4 ones: one seeded sequence, restarted
    for each package, makes both packages' ids equal."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def __call__(self):
        return uuid.UUID(bytes=self.rng.bytes(16), version=4)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("docs")
    written = write_corpus(root, 24, seed=5, words=(10, 140))
    assert sorted(set(written.values())) == sorted(FORMATS)
    return root


def _both(monkeypatch, corpus, tmp_path, **kw):
    monkeypatch.setattr(uuid, "uuid4", _SeededUUID())
    want = jingest.ingest(corpus, tmp_path / "j", **kw)
    monkeypatch.setattr(uuid, "uuid4", _SeededUUID())
    got = tingest.ingest(corpus, tmp_path / "t", device="cpu", **kw)
    return want, got


@pytest.mark.parametrize("chunker", ["recursive", "markdown", "token"])
def test_ingest_matches_jax(monkeypatch, corpus, tmp_path, chunker):
    want, got = _both(monkeypatch, corpus, tmp_path, chunker=chunker, chunk_size=300,
                      overlap=30, dim=32, bm25=True)
    assert got["files"] == want["files"] == 24
    assert got["chunks"] == want["chunks"] > 24
    assert set(got["stages_s"]) == {"parse", "chunk", "embed", "index", "save", "bm25"}
    j, t = tmp_path / "j", tmp_path / "t"
    assert (t / "bm25.json").read_text() == (j / "bm25.json").read_text()
    jrows = json.loads((j / "dense" / "docstore.json").read_text())
    trows = json.loads((t / "dense" / "docstore.json").read_text())
    assert trows == jrows
    assert {r["metadata"]["source"] for r in trows} == {
        str(p) for p in corpus.iterdir()}
    np.testing.assert_allclose(np.load(t / "dense" / "emb.npy"),
                               np.load(j / "dense" / "emb.npy"), rtol=0, atol=1e-6)
    assert np.array_equal(np.load(t / "dense" / "valid.npy"), np.load(j / "dense" / "valid.npy"))
    jm = json.loads((j / "dense" / "manifest.json").read_text())
    tm = json.loads((t / "dense" / "manifest.json").read_text())
    assert tm == jm


def test_blob_ingest_matches_jax_and_serves(monkeypatch, corpus, tmp_path):
    want, got = _both(monkeypatch, corpus, tmp_path, chunk_size=300, overlap=30, dim=32,
                      blob_docstore=True)
    assert got["chunks"] == want["chunks"]
    blobs = [tmp_path / p / "dense" / "docstore_blob" / "blob.jsonl" for p in ("j", "t")]
    assert blobs[1].read_bytes() == blobs[0].read_bytes()
    store = tpers.load_store(got["dense_snapshot"], HashEmbeddings(dim=32), device="cpu")
    assert isinstance(store.docstore, BlobDocstore) and len(store) == got["chunks"]
    texts = [d.content for _, d in list(store.docstore.items())[:8]]
    jstore = jpers.load_store(want["dense_snapshot"], JaxHash(dim=32))
    assert [[d.id for d, _ in h] for h in store.batch_similarity_search_with_score(texts, k=3)] \
        == [[d.id for d, _ in h] for h in jstore.batch_similarity_search_with_score(texts, k=3)]


def test_ingest_cli_and_refusals(corpus, tmp_path, capsys):
    assert tingest.main([str(corpus), "-o", str(tmp_path / "s"), "--chunker", "markdown",
                         "--device", "cpu", "--dtype", "bfloat16", "--bm25"]) == 0
    out = capsys.readouterr().out
    assert "chunks:" in out and "stages_s:" in out
    store = tpers.load_store(tmp_path / "s" / "dense", HashEmbeddings(dim=64), device="cpu")
    assert str(store.index.dtype) == "torch.bfloat16"
    assert tingest.main([str(corpus), "-o", str(tmp_path / "b"), "--blob-docstore",
                         "--device", "cpu"]) == 0
    assert (tmp_path / "b" / "dense" / "docstore_blob" / "blob.jsonl").exists()
    # IVF and HNSW build now: --nlist 8 trains the lists past 100 rows
    for index_type in ("ivf", "hnsw"):
        assert tingest.main([str(corpus), "-o", str(tmp_path / index_type), "--device",
                             "cpu", "--index-type", index_type, "--nlist", "8",
                             "--chunk-size", "120", "--overlap", "10"]) == 0
        store = tpers.load_store(tmp_path / index_type / "dense", HashEmbeddings(dim=64),
                                 device="cpu")
        assert store.index.stats()["kind"] == index_type
        text = next(iter(store.docstore.items()))[1].content
        assert store.similarity_search(text, k=1)[0].content == text
    for args, match in ((["--vlm-url", "http://localhost:1"], r"\[#16\]"),):
        with pytest.raises(NotImplementedError, match=match):
            tingest.main([str(corpus), "-o", str(tmp_path / "x"), "--device", "cpu", *args])
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="nothing"):
        tingest.ingest(tmp_path / "empty", tmp_path / "out", device="cpu")


@pytest.mark.parametrize("index_type", ["ivf", "hnsw"])
def test_ivf_hnsw_ingest_matches_jax(monkeypatch, corpus, tmp_path, index_type):
    want, got = _both(monkeypatch, corpus, tmp_path, chunk_size=120, overlap=10, dim=32,
                      index_type=index_type)
    assert got["chunks"] == want["chunks"] > 100  # past the IVF training threshold
    j, t = tmp_path / "j" / "dense", tmp_path / "t" / "dense"
    assert json.loads((t / "docstore.json").read_text()) == json.loads(
        (j / "docstore.json").read_text())
    jm = json.loads((j / "manifest.json").read_text())
    tm = json.loads((t / "manifest.json").read_text())
    assert tm.pop("dtype", "float32") == "float32"  # the port records the IVF dtype
    assert tm == jm and tm["index_kind"] == index_type
    jstore = jpers.load_store(j, JaxHash(dim=32))
    tstore = tpers.load_store(t, HashEmbeddings(dim=32), device="cpu")
    texts = [d.content for _, d in list(tstore.docstore.items())[:10]]
    got_ids = [[d.id for d, _ in h] for h in tstore.batch_similarity_search_with_score(texts, k=3)]
    assert got_ids == [[d.id for d, _ in h]
                       for h in jstore.batch_similarity_search_with_score(texts, k=3)]


def test_ingest_single_file_and_torch_embedder(corpus, tmp_path):
    one = sorted(corpus.glob("*.docx"))[0]
    stats = tingest.ingest(one, tmp_path / "one", dim=16, device="cpu")
    assert stats["files"] == 1 and stats["chunks"] >= 1
    with pytest.raises(ValueError, match="unknown embedder"):
        tingest.build_embedder("flax", 16, "cpu")
    emb = tingest.build_embedder("torch", 768, "cpu")
    assert emb.describe()["kind"] == "torch" and emb.cfg.depth == 12 and emb.dim == 768


# -- blob docstore ------------------------------------------------------------------


def _blob_store(pkg, path, texts, ids):
    if pkg == "jax":
        store = TPUVectorStore(JaxHash(dim=32), docstore_path=str(path))
    else:
        store = TorchVectorStore(HashEmbeddings(dim=32), docstore_path=str(path), device="cpu")
    store.add_texts(texts, metadatas=[{"n": i} for i in range(len(texts))], ids=ids)
    store.delete(ids[3:5])
    return store


@pytest.mark.parametrize("writer,reader", [("torch", "torch"), ("jax", "torch"),
                                           ("torch", "jax"), ("jax", "jax")])
def test_blob_snapshot_round_trip(tmp_path, writer, reader):
    texts = [f"document number {i} about topic {i % 5}" for i in range(30)]
    ids = [f"d{i}" for i in range(30)]
    src = _blob_store(writer, tmp_path / "live", texts, ids)
    (jpers if writer == "jax" else tpers).save_store(src, tmp_path / "snap")
    manifest = json.loads((tmp_path / "snap" / "manifest.json").read_text())
    assert manifest["docstore"] == "blob" and not (tmp_path / "snap" / "docstore.json").exists()
    if reader == "jax":
        loaded = jpers.load_store(tmp_path / "snap", JaxHash(dim=32))
        assert isinstance(loaded.docstore, JaxBlob)
    else:
        loaded = tpers.load_store(tmp_path / "snap", HashEmbeddings(dim=32), device="cpu")
        assert isinstance(loaded.docstore, BlobDocstore)
    assert len(loaded) == 28 and loaded.get_by_ids(["d3"]) == []
    assert loaded.get_by_ids(["d7"])[0].metadata == {"n": 7}
    queries = texts[:6]
    want = src.batch_similarity_search_with_score(queries, k=4)
    got = loaded.batch_similarity_search_with_score(queries, k=4)
    assert [[d.id for d, _ in h] for h in got] == [[d.id for d, _ in h] for h in want]
    # the reattached store takes further writes in the snapshot directory
    loaded.add_texts(["brand new text"], ids=["new"])
    assert loaded.similarity_search("brand new text", k=1)[0].id == "new"


def test_blob_store_delete_compact_and_parity(tmp_path):
    texts = [f"text {i} unique words {i * 7}" for i in range(40)]
    ids = [f"t{i}" for i in range(40)]
    j = TPUVectorStore(JaxHash(dim=16), docstore_path=str(tmp_path / "j"),
                       compact_threshold=0.2)
    t = TorchVectorStore(HashEmbeddings(dim=16), docstore_path=str(tmp_path / "t"),
                         compact_threshold=0.2, device="cpu")
    for store in (j, t):
        store.add_texts(texts, ids=ids)
        store.delete(ids[:12])  # crosses the threshold: both compact
        assert store.index.n_deleted == 0
    q = texts[12:20]
    assert [[d.id for d, _ in h] for h in t.batch_similarity_search_with_score(q, k=3)] == [
        [d.id for d, _ in h] for h in j.batch_similarity_search_with_score(q, k=3)]
    assert t.max_marginal_relevance_search(texts[15], k=3)[0].id == "t15"


def test_blob_docstore_copy_matches_jax(tmp_path):
    docs = [(f"id{i}", f"content {i}", {"i": i}) for i in range(50)]
    j, t = JaxBlob(tmp_path / "j"), BlobDocstore(tmp_path / "t")
    j.add([JaxDocument(content=c, metadata=m, id=i) for i, c, m in docs], list(range(50)))
    t.add([Document(content=c, metadata=m, id=i) for i, c, m in docs], list(range(50)))
    for store in (j, t):
        store.delete(["id4", "id9", "nope"])
        store.add([type(store.get_by_position(0))(content="rewritten", id="id1")], [60])
        store.reassign({60: 4})
    assert (tmp_path / "t" / "blob.jsonl").read_bytes() == (tmp_path / "j" / "blob.jsonl").read_bytes()
    assert len(t) == len(j) and t.all_ids() == j.all_ids()
    assert np.array_equal(t.live_positions(), j.live_positions())
    for pos in range(62):
        a, b = t.get_by_position(pos), j.get_by_position(pos)
        assert (a is None and b is None) or (a.id, a.content, a.metadata) == (b.id, b.content, b.metadata)
    t.save(tmp_path / "ts")
    back = JaxBlob(tmp_path / "ts")
    assert back.all_ids() == t.all_ids() and back.position_of("id1") == 4


# -- chunking and parsing (copies) ----------------------------------------------------


def _chunks(docs):
    return [(d.content, d.metadata) for d in docs]


def test_splitters_match_jax(corpus):
    from rag_arc_tpu_torch.parsing.multi import MultiParser

    texts = [d.markdown for d in MultiParser().parse_tree(corpus).values()]
    texts.append("# T\nintro\n\n```\n# code\n```\n\n## A\n" + "word " * 400)
    cases = [
        ("RecursiveCharacterTextSplitter", dict(chunk_size=120, chunk_overlap=20)),
        ("RecursiveCharacterTextSplitter", dict(chunk_size=50, chunk_overlap=0,
                                                keep_separator="end")),
        ("MarkdownHeaderTextSplitter", dict(max_chars=200, overlap=20)),
        ("MarkdownHeaderTextSplitter", dict(strip_headers=True)),
        ("TokenTextSplitter", dict(tokens_per_chunk=40, chunk_overlap=8)),
    ]
    for name, kw in cases:
        j, t = getattr(jsplit, name)(**kw), getattr(tsplit, name)(**kw)
        for text in texts:
            want = j.split_documents([JaxDocument(content=text, metadata={"s": 1})])
            got = t.split_documents([Document(content=text, metadata={"s": 1})])
            assert _chunks(got) == _chunks(want), name
    for ttype in ("percentile", "standard_deviation", "interquartile", "gradient"):
        j = jsplit.SemanticChunker(JaxHash(dim=32), breakpoint_threshold_type=ttype)
        t = tsplit.SemanticChunker(HashEmbeddings(dim=32), breakpoint_threshold_type=ttype)
        text = " ".join(f"Sentence {i} is about {'cats' if i < 6 else 'stocks'}." for i in range(12))
        assert t.split_text(text) == j.split_text(text), ttype


def test_parsers_match_jax(corpus, tmp_path):
    import shutil

    from tests.test_parsing import TestHtml, make_docx, make_pptx, make_xlsx

    extra = tmp_path / "extra"
    extra.mkdir()
    make_docx(extra)
    make_xlsx(extra, n_rows=7)
    make_pptx(extra)
    (extra / "page.html").write_text(TestHtml.HTML)
    (extra / "table.csv").write_text("a,b\n1,2\n3,4\n", encoding="utf-8")
    (extra / "skip.bin").write_bytes(b"\x00")
    for root in (corpus, extra):
        want = jmulti.MultiParser().parse_tree(root)
        got = tmulti.MultiParser().parse_tree(root)
        assert list(got) == list(want)
        for src in want:
            g, w = got[src], want[src]
            assert (g.markdown, g.source, g.metadata, g.assets) == (
                w.markdown, w.source, w.metadata, w.assets), src
    inline = TestHtml.HTML
    assert tmulti.MultiParser().parse(extra / "page.html").markdown == \
        jmulti.MultiParser().parse(extra / "page.html").markdown
    from rag_arc_tpu.parsing.html_parser import HtmlParser as JaxHtml
    from rag_arc_tpu_torch.parsing.html_parser import HtmlParser

    assert HtmlParser().parse(inline).markdown == JaxHtml().parse(inline).markdown
    with pytest.raises(ValueError, match="no parser"):
        tmulti.MultiParser().parse(extra / "skip.bin")
    with pytest.raises(NotImplementedError, match=r"\[#16\]"):
        tmulti.MultiParser(vlm_url="http://localhost:1")
    # the CLI writes the same markdown files as the JAX package's
    assert tmulti.main([str(extra / "test.docx"), "-o", str(tmp_path / "t")]) == 0
    assert jmulti.main([str(extra / "test.docx"), "-o", str(tmp_path / "j")]) == 0
    assert (tmp_path / "t" / "test.md").read_text() == (tmp_path / "j" / "test.md").read_text()
    shutil.rmtree(tmp_path / "t")
