"""The port's Neo4j mirror adapter against the JAX package's, on a
protocol-level fake driver (no neo4j package or server here): every case
of ``tests/test_neo4j_store.py`` runs through both stores with the same
operations, and the Cypher statements and parameters each driver received
must be equal (the mirrored embeddings to 1e-6), beside the JAX tests' own
assertions on the port's store."""

import numpy as np
import pytest

from rag_arc_tpu.graph import neo4j_store as j_neo4j
from rag_arc_tpu.graph import schema as j_schema
from rag_arc_tpu.models.embeddings import HashEmbeddings as JaxHash
from rag_arc_tpu_torch.graph import neo4j_store as t_neo4j
from rag_arc_tpu_torch.graph import schema as t_schema
from rag_arc_tpu_torch.graph.neo4j_store import Neo4jGraphStore
from rag_arc_tpu_torch.models.embeddings import HashEmbeddings


class FakeSession:
    def __init__(self, driver):
        self.driver = driver

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def run(self, query, **params):
        if self.driver.fail_next > 0:
            self.driver.fail_next -= 1
            raise ConnectionError("transient blip")
        self.driver.queries.append((query, params))
        if query.startswith("RETURN 1"):
            return [{"ok": 1}]
        return []


class FakeDriver:
    def __init__(self):
        self.queries = []
        self.databases = []
        self.fail_next = 0
        self.closed = False

    def session(self, database=None):
        self.databases.append(database)
        return FakeSession(self)

    def close(self):
        self.closed = True


def port_store(driver=None, **kw):
    driver = driver or FakeDriver()
    kw.setdefault("retry_wait_base", 0.0)
    return Neo4jGraphStore(HashEmbeddings(dim=16), driver=driver, device="cpu", **kw), driver


def jax_store(driver=None, **kw):
    driver = driver or FakeDriver()
    kw.setdefault("retry_wait_base", 0.0)
    return j_neo4j.Neo4jGraphStore(JaxHash(dim=16), driver=driver, **kw), driver


def same_queries(got, want):
    """Equal statements and parameters; embedding rows to 1e-6."""
    assert [q for q, _ in got] == [q for q, _ in want]
    for (_, gp), (_, wp) in zip(got, want):
        rows_g, rows_w = gp.get("rows"), wp.get("rows")
        if rows_g and "embedding" in rows_g[0]:
            assert [r["key"] for r in rows_g] == [r["key"] for r in rows_w]
            np.testing.assert_allclose([r["embedding"] for r in rows_g],
                                       [r["embedding"] for r in rows_w], atol=1e-6)
        else:
            assert gp == wp


def both(scenario, **kw):
    """Run ``scenario(store, schema)`` on a port and a JAX store; returns
    the port's (store, driver) after checking both drivers' queries."""
    (ts, tdrv), (js, jdrv) = port_store(**kw), jax_store(**kw)
    tout = scenario(ts, t_schema)
    jout = scenario(js, j_schema)
    assert tout == jout
    same_queries(tdrv.queries, jdrv.queries)
    assert tdrv.databases == jdrv.databases
    return ts, tdrv


def test_device_is_required_and_import_gated(monkeypatch):
    with pytest.raises(TypeError):
        Neo4jGraphStore(HashEmbeddings(dim=16), driver=FakeDriver())
    monkeypatch.setitem(__import__("sys").modules, "neo4j", None)
    with pytest.raises(ImportError, match="neo4j driver is not installed"):
        Neo4jGraphStore(HashEmbeddings(dim=16), device="cpu")
    with pytest.raises(NotImplementedError, match=r"\[#15\]"):
        port_store(mesh=object())


def test_schema_constraints_and_vector_indexes_up_front():
    _, driver = both(lambda s, sc: None, database="graphdb", batch_size=1)
    constraints = [q for q, _ in driver.queries if "CONSTRAINT" in q]
    assert len(constraints) == 3 and all("IF NOT EXISTS" in c for c in constraints)
    vector = [(q, p) for q, p in driver.queries if "VECTOR INDEX" in q]
    assert len(vector) == 3
    assert all("`vector.dimensions`: 16" in q for q, _ in vector)
    assert all(not p for _, p in vector)
    assert any(":Entity" in q for q, _ in vector)
    assert set(driver.databases) == {"graphdb"}


def test_upsert_mirrors_unwind_merge_cypher():
    def scenario(s, sc):
        s._driver.queries.clear()
        s.upsert_node(sc.GraphNode(key="paris", kind="entity", content="Paris",
                                   properties={"mentions": ["paris"], "blob": {"not": "x"}}))
        return sorted(s.nodes["entity"])

    store, driver = both(scenario, batch_size=1)
    (query, params), = driver.queries
    assert query.startswith("UNWIND $rows AS row MERGE (n:Entity {key: row.key})")
    (row,) = params["rows"]
    assert row["key"] == "paris" and row["props"] == {"mentions": ["paris"]}
    assert "paris" in store.nodes["entity"]


def test_edge_mirrored_once():
    def scenario(s, sc):
        for key in ("a", "b"):
            s.upsert_node(sc.GraphNode(key=key, kind="entity", content=key))
        s._driver.queries.clear()
        edge = sc.GraphEdge(src="a", dst="b", edge_type="ENTITY_RELATION",
                            properties={"relation_type": "rel"})
        return s.add_edge(edge), s.add_edge(edge)

    _, driver = both(scenario, batch_size=1)
    assert len(driver.queries) == 1
    query, params = driver.queries[0]
    assert "MERGE (a)-[r:ENTITY_RELATION]->(b)" in query
    assert params["rows"] == [{"src": "a", "dst": "b", "props": {"relation_type": "rel"}}]


def test_batched_writes_coalesce_into_one_unwind():
    def scenario(s, sc):
        s._driver.queries.clear()
        for i in range(10):
            s.upsert_node(sc.GraphNode(key=f"n{i}", kind="entity", content=f"c{i}"))
        buffered = list(s._driver.queries)
        s.flush()
        return buffered

    _, driver = both(scenario, batch_size=100)
    (query, params), = driver.queries
    assert query.startswith("UNWIND $rows AS row MERGE (n:Entity")
    assert len(params["rows"]) == 10


def test_batch_size_triggers_auto_flush():
    def scenario(s, sc):
        s._driver.queries.clear()
        for i in range(5):
            s.upsert_node(sc.GraphNode(key=f"n{i}", kind="chunk", content=f"c{i}"))

    _, driver = both(scenario, batch_size=5)
    assert len(driver.queries) == 1 and len(driver.queries[0][1]["rows"]) == 5


def test_failed_flush_requeues_rows():
    def scenario(s, sc):
        drv = s._driver
        drv.queries.clear()
        for i in range(4):
            s.upsert_node(sc.GraphNode(key=f"n{i}", kind="entity", content=f"c{i}"))
        drv.fail_next = 2
        with pytest.raises(ConnectionError):
            s.flush()
        assert drv.queries == [] and s._pending == 4  # nothing written, nothing lost
        s.upsert_node(sc.GraphNode(key="n4", kind="entity", content="c4"))
        s.flush()
        return s._pending

    store, driver = both(scenario, batch_size=100, max_retries=2)
    (query, params), = driver.queries
    assert query.startswith("UNWIND")
    assert {r["key"] for r in params["rows"]} == {f"n{i}" for i in range(5)}
    assert store._pending == 0


def test_nodes_flush_before_edges():
    def scenario(s, sc):
        s.upsert_node(sc.GraphNode(key="a", kind="entity", content="a"))
        s.upsert_node(sc.GraphNode(key="b", kind="entity", content="b"))
        s.add_edge(sc.GraphEdge(src="a", dst="b", edge_type="ENTITY_RELATION"))
        s._driver.queries.clear()
        s.flush()

    _, driver = both(scenario, batch_size=100)
    assert ["node" if "MERGE (n:" in q else "edge" for q, _ in driver.queries] == [
        "node", "edge"]


def test_generate_embeddings_mirrors_vectors():
    def scenario(s, sc):
        s.upsert_node(sc.GraphNode(key="e1", kind="entity", content="first entity"))
        s.upsert_node(sc.GraphNode(key="e2", kind="entity", content="second entity"))
        s._driver.queries.clear()
        return s.generate_embeddings()

    store, driver = both(scenario, batch_size=100)
    (query, params), = [(q, p) for q, p in driver.queries if "SET n.embedding" in q]
    assert "MATCH (n:Entity {key: row.key})" in query
    assert len(params["rows"]) == 2 and len(params["rows"][0]["embedding"]) == 16
    np.testing.assert_allclose(params["rows"][0]["embedding"],
                               HashEmbeddings(dim=16).encode(["first entity"])[0], atol=1e-6)


def test_transient_failure_retries_then_succeeds():
    def scenario(s, sc):
        s._driver.queries.clear()
        s._driver.fail_next = 2
        s.upsert_node(sc.GraphNode(key="x", kind="chunk", content="x"))

    _, driver = both(scenario, batch_size=1)
    assert len(driver.queries) == 1


def test_retries_exhausted_raises():
    def scenario(s, sc):
        s._driver.fail_next = 99
        with pytest.raises(ConnectionError, match="unreachable"):
            s.upsert_node(sc.GraphNode(key="y", kind="chunk", content="y"))

    both(scenario, batch_size=1)


def test_delete_graph_data_detach_deletes():
    def scenario(s, sc):
        s.upsert_node(sc.GraphNode(key="z", kind="event", content="z"))
        s._driver.queries.clear()
        s.delete_graph_data()
        return dict(s.nodes["event"])

    _, driver = both(scenario, batch_size=1)
    assert driver.queries[-1][0] == "MATCH (n) DETACH DELETE n"


def test_health_check_ok_and_degraded():
    def scenario(s, sc):
        ok = s.health_check()
        s._driver.fail_next = 99
        degraded = s.health_check()
        return ok["neo4j"], ok["backend"], degraded["status"], degraded["neo4j"]

    both(scenario, batch_size=1)
    ok, backend, status, neo4j = scenario(port_store(batch_size=1)[0], t_schema)
    assert (ok, backend, status) == ("ok", "array+neo4j", "degraded")
    assert "unreachable" in neo4j


def test_close_flushes_then_closes():
    def scenario(s, sc):
        s.upsert_node(sc.GraphNode(key="w", kind="chunk", content="w"))
        s._driver.queries.clear()
        s.close()
        return s._driver.closed

    _, driver = both(scenario, batch_size=100)
    assert driver.closed and any("MERGE (n:Chunk" in q for q, _ in driver.queries)


def test_store_pipeline_mirrors_the_merge_and_knn():
    """A HyperRAG store flow on the mirror: the merged graph and its Cypher
    equal the JAX adapter's."""
    def scenario(s, sc):
        k = sc.KnowledgeStructure(
            events=[sc.Event(id="E1", content="the pump failed at noon"),
                    sc.Event(id="E2", content="the pump failed at noon today")],
            entities=[sc.Entity(entity_name="tpu chip accelerator unit",
                                description="long detailed description"),
                      sc.Entity(entity_name="the tpu chip accelerator unit")])
        from importlib import import_module

        pkg = sc.__name__.rsplit(".", 2)[0]
        ExtractionResult = import_module(f"{pkg}.graph.extractor").ExtractionResult
        Document = import_module(f"{pkg}.utils.data_model").Document
        stats = s.store_hyperrag_graph(
            [ExtractionResult(document=Document(content="pump log", id="d"), knowledge=k)])
        return {key: stats[key] for key in ("entities", "entities_merged", "total_edges")}

    store, driver = both(scenario, batch_size=7, merge_threshold=0.8, knn_cutoff=0.7)
    assert store.get_graph_statistics()["entities"] == 1
    assert any("SET n.embedding" in q for q, _ in driver.queries)
    assert t_neo4j.Neo4jGraphStore.__mro__[1].__module__ == "rag_arc_tpu_torch.graph.store"
