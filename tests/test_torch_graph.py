"""Parity of the port's GraphRAG package with the JAX package's on the CPU.

Every case of ``tests/test_graph.py`` runs through both packages on the
same inputs (the same FakeLLM scripts, HashEmbeddings vectors and
extraction results, built from one spec in each package's schema) and
holds the port to the JAX package: extraction results equal; graph
statistics, edges (SIMILAR_TO scores within 1e-5) and the entity-merge
redirect map equal. Then the merge bench's corpora
(``rag_arc_tpu_torch/tools/graph_merge_bench.py``, the JAX tool's draws)
at n = 2,000, d = 64 through both stores: the similar-pair sets are equal
except pairs whose score lies within ``TIE`` (1e-5) of the threshold in
either package, or within ``TIE`` of its query's k-th score (a tie at the
top-k boundary); with equal pair sets the merges are equal. Graph
snapshots load across the packages in both directions. The graph configs
build and answer on the CPU.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rag_arc_tpu.graph import extractor as j_extractor
from rag_arc_tpu.graph import hyperrag as j_hyperrag
from rag_arc_tpu.graph import schema as j_schema
from rag_arc_tpu.graph import store as j_store
from rag_arc_tpu.llm.fake import FakeLLM as JaxFakeLLM
from rag_arc_tpu.models.embeddings import HashEmbeddings as JaxHash
from rag_arc_tpu.utils.data_model import Document as JaxDocument
from rag_arc_tpu_torch.graph import extractor as t_extractor
from rag_arc_tpu_torch.graph import hyperrag as t_hyperrag
from rag_arc_tpu_torch.graph import schema as t_schema
from rag_arc_tpu_torch.graph import store as t_store
from rag_arc_tpu_torch.llm.fake import FakeLLM
from rag_arc_tpu_torch.models.embeddings import HashEmbeddings
from rag_arc_tpu_torch.tools import graph_merge_bench as gmb
from rag_arc_tpu_torch.utils.data_model import Document

TIE = 1e-5  # f32 cosine sums in another order: pairs this close to a boundary may differ


def _pkg(schema, extractor, hyperrag, store, llm, emb, doc, **store_kw):
    return SimpleNamespace(
        s=schema, ExtractionResult=extractor.ExtractionResult,
        Extractor=hyperrag.HyperRAGGraphExtractor, FakeLLM=llm, Hash=emb, Document=doc,
        Store=lambda embeddings, **kw: store.ArrayGraphStore(embeddings, **store_kw, **kw),
    )


JAX = _pkg(j_schema, j_extractor, j_hyperrag, j_store, JaxFakeLLM, JaxHash, JaxDocument)
PORT = _pkg(t_schema, t_extractor, t_hyperrag, t_store, FakeLLM, HashEmbeddings, Document,
            device="cpu")
BOTH = (JAX, PORT)


def ks(p, events=(), entities=(), ev_rels=(), en_rels=()):
    return p.s.KnowledgeStructure(
        events=[p.s.Event(**e) for e in events],
        entities=[p.s.Entity(**e) for e in entities],
        event_relations=[p.s.EventRelation(**r) for r in ev_rels],
        entity_relations=[p.s.EntityRelation(**r) for r in en_rels],
    )


E1 = dict(id="E1", content="the reactor was started", participants=["reactor"])
E2 = dict(id="E2", content="pressure rose sharply", participants=[])
ENT_R = dict(entity_name="reactor", entity_type="object", description="main reactor")
ENT_P = dict(entity_name="pressure sensor", entity_type="object")


def record_redirects(store):
    """Wrap the store's merge apply so each redirect map it applies is kept."""
    seen = []
    apply = store._apply_entity_merges

    def recorded(redirect):
        seen.append(dict(redirect))
        return apply(redirect)

    store._apply_entity_merges = recorded
    return seen


def edge_rows(store):
    return [(e.src, e.dst, e.edge_type,
             {k: v for k, v in e.properties.items() if k != "score"},
             e.properties.get("score")) for e in store.edges]


def assert_same_graph(jstore, tstore):
    assert tstore.get_graph_statistics() == jstore.get_graph_statistics()
    assert {k: {n: v.model_dump() for n, v in nodes.items()}
            for k, nodes in tstore.nodes.items()} == {
        k: {n: v.model_dump() for n, v in nodes.items()} for k, nodes in jstore.nodes.items()}
    jrows, trows = edge_rows(jstore), edge_rows(tstore)
    assert [r[:4] for r in trows] == [r[:4] for r in jrows]
    for (*_, js), (*_, ts) in zip(jrows, trows):
        assert (js is None) == (ts is None)
        if js is not None:
            assert abs(js - ts) <= TIE


# -- schema ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda s: s.Event(id="X1", content="bad id"),
    lambda s: s.Entity(entity_name="   "),
    lambda s: s.GraphEdge(src="a", dst="b", edge_type="BOGUS"),
], ids=["event_id_pattern", "entity_name_nonempty", "edge_type"])
def test_schema_refuses_as_the_jax_schema(make):
    for p in BOTH:
        with pytest.raises(Exception):
            make(p.s)
    ok = dict(id="E3", content="c", participants=["x"])
    assert t_schema.Event(**ok).model_dump() == j_schema.Event(**ok).model_dump()


# -- extraction -----------------------------------------------------------------------


def extract(p, script, clean, docs=("log",), **kw):
    llm = p.FakeLLM(responses=script(p))
    ex = p.Extractor(llm, clean=clean, **kw)
    return ex([p.Document(content=c) for c in docs])


def both_extract(script, clean, **kw):
    jres, tres = (extract(p, script, clean, **kw) for p in BOTH)
    assert [r.knowledge.model_dump() for r in tres] == [r.knowledge.model_dump() for r in jres]
    assert [r.rounds for r in tres] == [r.rounds for r in jres]
    return tres


def test_multi_round_until_empty():
    res = both_extract(lambda p: [ks(p, events=[E1], entities=[ENT_R]), ks(p)], clean=False)
    assert res[0].rounds == 2 and len(res[0].knowledge.events) == 1
    assert res[0].document.metadata["knowledge"] == res[0].knowledge.model_dump()
    json.dumps(res[0].document.metadata)


def test_dedup_by_event_id_and_entity_name():
    res = both_extract(lambda p: [
        ks(p, events=[E1], entities=[ENT_R]),
        ks(p, events=[E1, E2], entities=[dict(entity_name="Reactor")]),
        ks(p),
    ], clean=False)
    k = res[0].knowledge
    assert [e.id for e in k.events] == ["E1", "E2"] and len(k.entities) == 1


def test_duplicate_event_relations_remap_to_kept_id():
    dup = dict(id="E7", content="the reactor was started", participants=[])
    rel = dict(head_event="E7", tail_event="E2", relation_type="CAUSES")
    res = both_extract(lambda p: [
        ks(p, events=[E1]), ks(p, events=[dup, E2], ev_rels=[rel]), ks(p),
    ], clean=False)
    k = res[0].knowledge
    assert [e.id for e in k.events] == ["E1", "E2"]
    assert [(r.head_event, r.tail_event) for r in k.event_relations] == [("E1", "E2")]


def test_llm_failure_isolated_per_document():
    def flaky(p):
        class Flaky(p.FakeLLM):
            def __init__(self):
                super().__init__()
                self.n = 0

            def parse_chat(self, messages, response_format, **kw):
                self.n += 1
                if "bad" in messages[-1]["content"]:
                    raise RuntimeError("boom")
                return ks(p, events=[E1]) if self.n < 3 else ks(p)

        ex = p.Extractor(Flaky(), clean=False, max_concurrent=1)
        return ex([p.Document(content="good text"), p.Document(content="bad text")])

    jres, tres = flaky(JAX), flaky(PORT)
    assert [r.knowledge.model_dump() for r in tres] == [r.knowledge.model_dump() for r in jres]
    ok = [r for r in tres if "good" in r.document.content][0]
    bad = [r for r in tres if "bad" in r.document.content][0]
    assert ok.knowledge.events and not bad.knowledge.events


def test_clean_regex_prefilter():
    junk = [dict(entity_name=n) for n in ("42", "it", "the", "x")]
    res = both_extract(lambda p: [
        ks(p, events=[E1], entities=[ENT_R] + junk), ks(p),
        p.s.EntityReview(keep=["reactor"]),
    ], clean=True)
    assert [e.entity_name for e in res[0].knowledge.entities] == ["reactor"]


def test_clean_resolves_event_relations_and_drops_dangling():
    rels = [dict(head_event="E1", tail_event="E2", relation_type="CAUSES"),
            dict(head_event="E1", tail_event="E9", relation_type="CAUSES"),
            dict(head_event="E1", tail_event="E1", relation_type="SELF")]
    res = both_extract(lambda p: [
        ks(p, events=[E1, E2], entities=[ENT_R], ev_rels=rels), ks(p),
        p.s.EntityReview(keep=["reactor"]),
    ], clean=True, docs=("t",))
    k = res[0].knowledge
    assert len(k.event_relations) == 1 and k.event_relations[0].head_event == E1["content"]


def test_clean_entity_relations_dropped_when_entity_dropped():
    rels = [dict(head_entity="reactor", tail_entity="42"),
            dict(head_entity="reactor", tail_entity="reactor")]
    res = both_extract(lambda p: [
        ks(p, entities=[ENT_R, dict(entity_name="42")], en_rels=rels), ks(p),
        p.s.EntityReview(keep=["reactor"]),
    ], clean=True, docs=("t",))
    assert res[0].knowledge.entity_relations == []


def test_review_failure_keeps_prefiltered():
    def run(p):
        class ReviewBoom(p.FakeLLM):
            def parse_chat(self, messages, response_format, **kw):
                if response_format is p.s.EntityReview:
                    raise RuntimeError("review down")
                return super().parse_chat(messages, response_format, **kw)

        llm = ReviewBoom(responses=[ks(p, events=[E1], entities=[ENT_R, ENT_P]), ks(p)])
        return p.Extractor(llm)([p.Document(content="t")])

    jres, tres = run(JAX), run(PORT)
    assert tres[0].knowledge.model_dump() == jres[0].knowledge.model_dump()
    assert {e.entity_name for e in tres[0].knowledge.entities} == {"reactor", "pressure sensor"}


# -- the store --------------------------------------------------------------------------


def extracted(p):
    doc1 = p.Document(content="reactor startup procedure log", id="d1")
    doc2 = p.Document(content="pressure sensor calibration log", id="d2")
    k1 = ks(p, events=[E1, E2], entities=[ENT_R, ENT_P],
            ev_rels=[dict(head_event=E1["content"], tail_event=E2["content"],
                          relation_type="CAUSES")],
            en_rels=[dict(head_entity="reactor", tail_entity="pressure sensor",
                          relation_type="MONITORED_BY")])
    k2 = ks(p, entities=[dict(entity_name="pressure sensor", description="dup")])
    return [p.ExtractionResult(document=doc1, knowledge=k1),
            p.ExtractionResult(document=doc2, knowledge=k2)]


def both_stores(results, dim=32, **kw):
    """Store ``results(p)`` in a JAX and a port store; returns (jax store,
    port store, their stats, their redirect maps)."""
    out = []
    for p in BOTH:
        store = p.Store(p.Hash(dim=dim), **kw)
        redirects = record_redirects(store)
        stats = store.store_hyperrag_graph(results(p))
        out.append((store, stats, redirects))
    (js, jstats, jred), (ts, tstats, tred) = out
    assert tstats == jstats
    assert tred == jred
    assert_same_graph(js, ts)
    return js, ts, tstats, tred


def test_pipeline_and_statistics():
    _, _, stats, _ = both_stores(extracted)
    assert (stats["chunks"], stats["events"], stats["entities"]) == (2, 2, 2)
    assert stats["contains_edges"] == 2 and stats["participates_edges"] == 1
    assert stats["entity_relation_edges"] == 1 and stats["event_relation_edges"] >= 1
    assert stats["entities_with_embeddings"] == 2 and len(stats) >= 13


def test_idempotent_restore():
    js, ts, _, _ = both_stores(extracted)
    s1 = ts.get_graph_statistics()
    assert ts.filter_existing_chunks([r.document for r in extracted(PORT)]) == []
    ts.store_hyperrag_graph(extracted(PORT))
    js.store_hyperrag_graph(extracted(JAX))
    assert ts.get_graph_statistics() == s1
    assert_same_graph(js, ts)


def test_entity_merge_near_duplicates():
    def results(p):
        k = ks(p, entities=[
            dict(entity_name="tpu chip accelerator unit",
                 description="long detailed description"),
            dict(entity_name="the tpu chip accelerator unit"),
            dict(entity_name="banana bread"),
        ])
        return [p.ExtractionResult(document=p.Document(content="chunk", id="c"), knowledge=k)]

    _, ts, stats, redirects = both_stores(results, dim=64, merge_threshold=0.8)
    assert stats["entities_merged"] >= 1 and redirects
    assert "banana bread" in ts.nodes["entity"]
    assert len([n for n in ts.nodes["entity"].values() if "tpu" in n.key]) == 1


def test_event_disambiguation_adds_similar_edges():
    def results(p):
        k = ks(p, events=[
            dict(id="E1", content="the pump failed at noon"),
            dict(id="E2", content="the pump failed at noon today"),
            dict(id="E3", content="lunch was served in the cafeteria"),
        ])
        return [p.ExtractionResult(document=p.Document(content="c", id="c"), knowledge=k)]

    _, ts, stats, _ = both_stores(results, dim=64, knn_cutoff=0.7)
    assert stats["similar_event_pairs"] >= 1
    similar = [e for e in ts.edges if e.edge_type == "EVENT_RELATION"
               and e.properties.get("relation_type") == "SIMILAR_TO"]
    assert similar and all("score" in e.properties for e in similar)


def test_entity_linked_chunk_retrieval():
    js, ts, _, _ = both_stores(extracted)
    docs = ts.entity_linked_chunks("reactor", k=2)
    want = js.entity_linked_chunks("reactor", k=2)
    assert [(d.content, d.id, d.metadata["chunk_key"]) for d in docs] == [
        (d.content, d.id, d.metadata["chunk_key"]) for d in want]
    np.testing.assert_allclose([d.metadata["graph_score"] for d in docs],
                               [d.metadata["graph_score"] for d in want], atol=TIE)
    assert docs[0].content == "reactor startup procedure log"


def test_search_nodes():
    js, ts, _, _ = both_stores(extracted)
    hits, want = ts.search_nodes("event", "pressure rise", k=2), js.search_nodes(
        "event", "pressure rise", k=2)
    assert [n.key for n, _ in hits] == [n.key for n, _ in want]
    np.testing.assert_allclose([s for _, s in hits], [s for _, s in want], atol=TIE)
    assert hits and "pressure" in hits[0][0].content


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_loads_across_packages(direction, tmp_path):
    src, dst = (JAX, PORT) if direction == "jax_to_port" else (PORT, JAX)
    store = src.Store(src.Hash(dim=32))
    store.store_hyperrag_graph(extracted(src))
    path = tmp_path / "graph.json"
    store.save(path)

    class Counting(dst.Hash):
        calls = 0

        def encode(self, texts):
            Counting.calls += 1
            return super().encode(texts)

    back = dst.Store(Counting(dim=32))
    back.load(path)
    assert Counting.calls == 0  # the sidecars restore; nothing re-encodes
    assert back.get_graph_statistics() == store.get_graph_statistics()
    assert [n.key for n, _ in back.search_nodes("event", "pressure rise", k=2)] == [
        n.key for n, _ in store.search_nodes("event", "pressure rise", k=2)]
    assert back.entity_linked_chunks("reactor", k=1)
    for kind, pos in back._positions.items():
        keys = list(pos)
        if keys:
            np.testing.assert_array_equal(
                back._indexes[kind].take(np.asarray([pos[k] for k in keys])),
                store._indexes[kind].take(
                    np.asarray([store._positions[kind][k] for k in keys])))


def test_persistence_roundtrip(tmp_path):
    ts = PORT.Store(HashEmbeddings(dim=32))
    ts.store_hyperrag_graph(extracted(PORT))
    p = tmp_path / "graph.json"
    ts.save(p)
    assert json.loads(p.read_text())["format"] == "rag_arc_tpu.graph.v1"
    assert (tmp_path / "graph.json.emb_entity.npy").exists()
    back = PORT.Store(HashEmbeddings(dim=32))
    back.load(p)
    assert back.get_graph_statistics() == ts.get_graph_statistics()
    assert back.entity_linked_chunks("reactor", k=1)


def test_load_with_different_embedder_dim_reencodes(tmp_path):
    js = JAX.Store(JaxHash(dim=32))
    js.store_hyperrag_graph(extracted(JAX))
    p = tmp_path / "graph.json"
    js.save(p)
    ts = PORT.Store(HashEmbeddings(dim=16))
    ts.load(p)
    j16 = JAX.Store(JaxHash(dim=16))
    j16.load(p)
    assert ts.get_graph_statistics() == js.get_graph_statistics()
    assert ts._indexes["event"].dim == 16
    assert [n.key for n, _ in ts.search_nodes("event", "pressure rise", k=1)] == [
        n.key for n, _ in j16.search_nodes("event", "pressure rise", k=1)]


def test_delete_and_health():
    js, ts, _, _ = both_stores(extracted)
    health = ts.health_check()
    assert health["status"] == "ok" and health == js.health_check()
    ts.delete_graph_data()
    assert ts.get_graph_statistics()["total_nodes"] == 0


def test_device_is_required_and_mesh_refused():
    with pytest.raises(TypeError):
        t_store.ArrayGraphStore(HashEmbeddings(dim=8))
    with pytest.raises(NotImplementedError, match=r"\[#15\]"):
        t_store.ArrayGraphStore(HashEmbeddings(dim=8), mesh=object(), device="cpu")
    store = t_store.ArrayGraphStore(HashEmbeddings(dim=8), device="cpu")
    store.upsert_node(t_schema.GraphNode(key="a", kind="entity", content="a b"))
    store.generate_embeddings()
    assert store._indexes["entity"].device.type == "cpu"
    assert store._indexes["entity"].dtype == torch.float32  # as the JAX default


def test_moderate_scale_store_unsharded_matches_jax_mesh():
    """tests/test_graph.py's 40-chunk corpus: the JAX store sharded over
    the 8-device CPU mesh, the port's unsharded (its mesh waits for [#15])."""
    from rag_arc_tpu.parallel.mesh import default_mesh

    def results(p):
        out = []
        for c in range(40):
            k = ks(p, events=[dict(id="E1", content=f"event in chunk {c} about area {c % 8}",
                                   participants=[f"area {c % 8}"])],
                   entities=[dict(entity_name=f"area {c % 8}", entity_type="concept"),
                             dict(entity_name=f"unique entity {c}")])
            out.append(p.ExtractionResult(
                document=p.Document(content=f"chunk {c} covers area {c % 8} details",
                                    id=f"c{c}"), knowledge=k))
        return out

    js = j_store.ArrayGraphStore(JaxHash(dim=32), mesh=default_mesh())
    ts = PORT.Store(HashEmbeddings(dim=32))
    jred, tred = record_redirects(js), record_redirects(ts)
    jstats = js.store_hyperrag_graph(results(JAX))
    tstats = ts.store_hyperrag_graph(results(PORT))
    assert tstats == jstats and tred == jred
    assert_same_graph(js, ts)
    assert tstats["chunks"] == 40 and tstats["entities"] == 8 + 40
    docs = ts.entity_linked_chunks("area 3 details", k=5)
    assert docs and all("area 3" in d.content for d in docs)
    assert [d.id for d in docs] == [d.id for d in js.entity_linked_chunks("area 3 details", k=5)]


# -- the merge bench's corpora ---------------------------------------------------------


def self_search(store, kind, top_k):
    """(keys, scores, hits) of the kind's self-search, as _similar_pairs runs it."""
    pos = store._positions[kind]
    keys = list(pos)
    index = store._indexes[kind]
    vecs = index.take(np.asarray([pos[k] for k in keys]))
    s, h = index.search(vecs, min(top_k + 1, len(keys)))
    return keys, s, h


def excused(pair, score, thr, kth):
    """A pair one package found and the other did not is allowed only at a
    tie: its score within TIE of the threshold, or of either key's k-th
    score in either package (the top-k boundary)."""
    a, b = pair
    return any(abs(score - v) <= TIE for v in (thr, *kth[a], *kth[b]))


def compare_pairs(js, ts, kind, thr, top_k):
    jp = {(a, b): s for a, b, s in js._similar_pairs(kind, thr, top_k)}
    tp = {(a, b): s for a, b, s in ts._similar_pairs(kind, thr, top_k)}
    kth = {}
    for store in (js, ts):
        keys, s, _ = self_search(store, kind, top_k)
        for key, row in zip(keys, s):
            kth.setdefault(key, []).append(float(row[-1]))
    for pair in set(jp) ^ set(tp):
        score = jp.get(pair, tp.get(pair))
        assert excused(pair, score, thr, kth), (pair, score)
    for pair in set(jp) & set(tp):
        assert abs(jp[pair] - tp[pair]) <= TIE
    return set(jp) == set(tp), len(tp)


def planted(names, vecs, edges=()):
    stores = []
    for p in BOTH:
        store = p.Store(gmb.VecEmbeddings(dict(zip(names, vecs))))
        store.embed_batch = 8192
        for name in names:
            store.upsert_node(p.s.GraphNode(key=name, kind="entity", content=name))
        for a, b in edges:
            store.add_edge(p.s.GraphEdge(src=a, dst=b, edge_type="ENTITY_RELATION"))
        store.generate_embeddings()
        stores.append(store)
    return stores


def test_hard_corpus_merge_matches_jax():
    corpus = gmb.hard_corpus(2000, 64, seed=0)
    assert len(corpus.names) == 2000 and corpus.vecs.shape == (2000, 64)
    js, ts = planted(corpus.names, corpus.vecs, corpus.edges)
    assert_same_graph(js, ts)
    same, n_pairs = compare_pairs(js, ts, "entity", 0.95, 10)
    assert n_pairs > 100
    jred, tred = record_redirects(js), record_redirects(ts)
    merged = ts.merge_duplicate_entities()
    assert merged == js.merge_duplicate_entities() > 0
    report = gmb.hard_report(ts, corpus)
    assert report["dangling_edges"] == 0 and report["entity_self_loops"] == 0
    if same:
        assert tred == jred
        assert report == gmb.hard_report(js, corpus)
        assert_same_graph(js, ts)


def test_default_corpus_merge_matches_jax():
    names, vecs, n_dup = gmb.default_corpus(2000, 64, seed=0)
    js, ts = planted(names, vecs)
    same, n_pairs = compare_pairs(js, ts, "entity", 0.95, 10)
    assert n_pairs >= n_dup
    jred, tred = record_redirects(js), record_redirects(ts)
    assert ts.merge_duplicate_entities() == js.merge_duplicate_entities() == n_dup
    if same:
        assert tred == jred
        assert_same_graph(js, ts)


def test_event_knn_matches_jax():
    """disambiguate_events over the default corpus as events (cutoff 0.85)."""
    names, vecs, _ = gmb.default_corpus(1500, 64, seed=1)
    stores = []
    for p in BOTH:
        store = p.Store(gmb.VecEmbeddings(dict(zip(names, vecs))))
        for name in names:
            store.upsert_node(p.s.GraphNode(key=name, kind="event", content=name))
        store.generate_embeddings()
        stores.append(store)
    js, ts = stores
    same, _ = compare_pairs(js, ts, "event", 0.85, 10)
    added = ts.disambiguate_events()
    assert added == js.disambiguate_events() > 0
    if same:
        assert_same_graph(js, ts)


def test_merge_bench_main_on_cpu(capsys):
    hard = gmb.main(["--hard", "--n", "1200", "--dim", "64", "--device", "cpu"])
    assert hard["dangling_edges"] == 0 and hard["entity_self_loops"] == 0
    assert hard["merged_entities"] > 0
    default = gmb.main(["--n", "1200", "--dim", "64", "--device", "cpu", "--oracle-n", "300"])
    assert default["planted_recall"] == 1.0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [line["n_entities"] for line in lines] == [1200, 1200]


# -- configs ---------------------------------------------------------------------------


def test_graph_configs_build_and_answer(tmp_path):
    from rag_arc_tpu.serving.configs import GraphStoreConfig as JaxStoreConfig
    from rag_arc_tpu_torch.serving.configs import GraphExtractorConfig, GraphStoreConfig

    ex = GraphExtractorConfig.model_validate(
        {"llm": {"type": "FAKE_LLM"}, "max_rounds": 2, "entity_types": ["machine"]}).build()
    assert isinstance(ex, t_hyperrag.HyperRAGGraphExtractor)
    assert ex.max_rounds == 2 and list(ex.prompt.entity_types) == ["machine"]
    assert ex([Document(content="a log line")])[0].rounds >= 1

    doc = {"embeddings": {"type": "HASH_EMBEDDINGS", "dim": 32}, "knn_cutoff": 0.8}
    cfg = GraphStoreConfig.model_validate(doc)
    store = cfg.build(device="cpu")
    assert store.device.type == "cpu" and store.knn_cutoff == 0.8
    store.store_hyperrag_graph(extracted(PORT))
    path = tmp_path / "g.json"
    store.save(path)
    snap = dict(doc, snapshot_path=str(path))
    back = GraphStoreConfig.model_validate(snap).build(device="cpu")
    jback = JaxStoreConfig.model_validate(snap).build()
    assert back.get_graph_statistics() == store.get_graph_statistics()
    assert back.get_graph_statistics() == jback.get_graph_statistics()
    assert [d.id for d in back.entity_linked_chunks("reactor", k=2)] == [
        d.id for d in jback.entity_linked_chunks("reactor", k=2)]


def _jax_pair_loop(keys, scores, hits, by_pos, threshold):
    """The JAX package's pair loop (``graph/store.py:341-358``), literally."""
    pairs = []
    for i, key in enumerate(keys):
        for score, pos in zip(scores[i], hits[i]):
            if pos < 0 or score < threshold:
                continue
            other = by_pos.get(int(pos))
            if other is None or other == key:
                continue
            a, b = sorted((key, other))
            pairs.append((a, b, float(score)))
    seen, out = set(), []
    for a, b, s in pairs:
        if (a, b) not in seen:
            seen.add((a, b))
            out.append((a, b, s))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_filter_equals_the_jax_loop(seed):
    """The port's numpy hit filter gives the JAX loop's pairs, in its order,
    bit for bit: -1 hits, hits of tombstoned positions, the self-match, f32
    scores at the threshold and one ULP either side of it, NaN."""
    rng = np.random.default_rng(seed)
    n, k, thr = 300, 8, 0.95
    store = PORT.Store(HashEmbeddings(dim=8))
    keys = [f"k{i}" for i in range(n)]
    store._positions["entity"] = {key: int(p) for key, p in zip(keys, rng.permutation(n + 40))}
    hits = rng.integers(-1, n + 40, (n, k))
    hits[:, 0] = [store._positions["entity"][key] for key in keys]  # the self-match
    at = np.float32(thr)
    pool = np.array([at, np.nextafter(at, np.float32(0)), np.nextafter(at, np.float32(2)),
                     np.nan, 0.5, 0.99, -np.inf], dtype=np.float32)
    scores = np.where(rng.random((n, k)) < 0.5, rng.choice(pool, (n, k)),
                      rng.random((n, k)).astype(np.float32) * 0.1 + 0.9).astype(np.float32)
    got = store._pairs_from_hits("entity", keys, scores, hits, thr)
    want = _jax_pair_loop(keys, scores, hits, store._key_by_position("entity"), thr)
    assert [(a, b, repr(s)) for a, b, s in got] == [(a, b, repr(s)) for a, b, s in want]
    assert len(want) > 50 and any(np.isnan(s) for _, _, s in want)
