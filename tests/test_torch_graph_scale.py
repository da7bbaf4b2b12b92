"""The port's graph store at 100,000 nodes and 1M edges against the JAX
store (``tests/test_graph.py``'s adjacency case), in a file of its own so
one worker carries it: the same nodes and edges go into both stores;
neighbour lookups are O(degree) through the adjacency index; one batched
merge of 500 losers rebuilds the edge list once; the edge lists, the
adjacency and the nodes equal the JAX store's afterwards."""

import time

from rag_arc_tpu.graph.schema import GraphEdge as JaxEdge
from rag_arc_tpu.graph.schema import GraphNode as JaxNode
from rag_arc_tpu.graph.store import ArrayGraphStore as JaxStore
from rag_arc_tpu.models.embeddings import HashEmbeddings as JaxHash
from rag_arc_tpu_torch.graph.schema import GraphEdge, GraphNode
from rag_arc_tpu_torch.graph.store import ArrayGraphStore
from rag_arc_tpu_torch.models.embeddings import HashEmbeddings

N_NODES, N_EDGES = 100_000, 1_000_000


def build(store, node_cls, edge_cls) -> float:
    t0 = time.time()
    for i in range(N_NODES):
        store.nodes["entity"][f"e{i}"] = node_cls(key=f"e{i}", kind="entity",
                                                  content=f"entity {i}")
    # ring + random chords
    for i in range(N_EDGES):
        src = f"e{i % N_NODES}"
        dst = f"e{(i * 131 + 7) % N_NODES}"
        if src != dst:
            store.add_edge(edge_cls(src=src, dst=dst, edge_type="ENTITY_RELATION",
                                    properties={"relation_type": f"r{i % 97}"}))
    return time.time() - t0


def edge_keys(store):
    return [(e.src, e.dst, e.edge_type, e.properties.get("relation_type")) for e in store.edges]


def test_100k_nodes_1M_edges_adjacency():
    store = ArrayGraphStore(HashEmbeddings(dim=16), device="cpu")
    build_s = build(store, GraphNode, GraphEdge)
    assert len(store.edges) > 0.9 * N_EDGES

    t0 = time.time()
    total = sum(len(store.neighbors("entity", f"e{i}")) for i in range(2000))
    lookup_s = time.time() - t0
    assert total > 0
    assert lookup_s < 2.0, f"2000 neighbor lookups took {lookup_s:.2f}s"

    redirect = {f"e{i}": f"e{i + 50_000}" for i in range(500)}
    t0 = time.time()
    merged = store._apply_entity_merges(dict(redirect))
    merge_s = time.time() - t0
    assert merged == 500
    assert merge_s < 30.0, f"batch merge took {merge_s:.2f}s"
    assert all(f"e{i}" not in store.nodes["entity"] for i in range(500))
    assert store.degree("e0") == 0
    nb = store.neighbors("entity", "e50000")
    assert nb and all(e.src == "e50000" or e.dst == "e50000" for _, e in nb)
    assert build_s < 120.0, f"graph build took {build_s:.1f}s"

    jstore = JaxStore(JaxHash(dim=16))
    build(jstore, JaxNode, JaxEdge)
    assert jstore._apply_entity_merges(dict(redirect)) == merged
    assert edge_keys(store) == edge_keys(jstore)
    assert dict(store._adj) == dict(jstore._adj)
    assert store._edge_keys == jstore._edge_keys
    assert set(store.nodes["entity"]) == set(jstore.nodes["entity"])
    assert store.get_graph_statistics() == jstore.get_graph_statistics()
