"""Neo4j-backed graph store (optional adapter; counterpart of
``rag_arc_tpu/graph/neo4j_store.py``, its behaviour unchanged over the
port's ``ArrayGraphStore``, whose ``device`` it passes through).

Parity with the reference's ``GraphStoreBaseNeo4j`` / ``HyperRAGNeo4jStore``
(``encapsulation/database/graph_db/``), inverted: the reference pushed
graph ML *into* the database (GDS Louvain/KNN, APOC merges); here Neo4j is
pure persistence behind the array store — entity merge and event
disambiguation still run on the flat index's top-k search, and the resulting
nodes/edges are mirrored to Neo4j.

Write path (Base_Neo4j parity pieces):
- MERGE-idempotent Cypher via batched ``UNWIND $rows`` statements — one
  round trip per ``batch_size`` (default 100, the reference's batch,
  ``Base_Neo4j.py:161-384``) instead of one per node/edge; edges flush
  after their endpoint nodes.
- constraints + 768-dim cosine VECTOR INDEXES created up front
  (``event_graphrag_neo4j.py:266-300`` parity).
- node embeddings mirrored into ``n.embedding`` after the backfill pass,
  so Neo4j-side vector queries work on a mirrored database.
- retry with exponential backoff on transient errors
  (``Base_Neo4j.py:27-32`` parity).

Gated: requires the ``neo4j`` driver and a reachable server; everything
else in the framework uses ``ArrayGraphStore``.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from rag_arc_tpu_torch.graph.schema import GraphEdge, GraphNode
from rag_arc_tpu_torch.graph.store import ArrayGraphStore
from rag_arc_tpu_torch.models.embeddings import Embeddings

logger = logging.getLogger(__name__)

_LABELS = {"chunk": "Chunk", "event": "Event", "entity": "Entity"}

_CONSTRAINTS = [
    "CREATE CONSTRAINT chunk_key IF NOT EXISTS FOR (n:Chunk) REQUIRE n.key IS UNIQUE",
    "CREATE CONSTRAINT event_key IF NOT EXISTS FOR (n:Event) REQUIRE n.key IS UNIQUE",
    "CREATE CONSTRAINT entity_key IF NOT EXISTS FOR (n:Entity) REQUIRE n.key IS UNIQUE",
]

# dim is interpolated, not a $parameter: Neo4j rejects query parameters in
# schema commands (CREATE INDEX/CONSTRAINT); dim is int()-coerced upstream
_VECTOR_INDEX = (
    "CREATE VECTOR INDEX {name} IF NOT EXISTS FOR (n:{label}) "
    "ON n.embedding OPTIONS {{indexConfig: {{"
    "`vector.dimensions`: {dim}, `vector.similarity_function`: 'cosine'}}}}"
)


def _scalar_props(props: Dict[str, Any], allow_list: bool = True) -> Dict[str, Any]:
    kinds = (str, int, float, bool, list) if allow_list else (str, int, float, bool)
    return {k: v for k, v in props.items() if isinstance(v, kinds)}


class Neo4jGraphStore(ArrayGraphStore):
    """ArrayGraphStore that mirrors every upsert to a Neo4j server."""

    def __init__(
        self,
        embeddings: Embeddings,
        uri: str = "bolt://localhost:7687",
        user: str = "neo4j",
        password: str = "neo4j",
        database: str = "neo4j",
        max_retries: int = 3,
        driver: Optional[Any] = None,
        retry_wait_base: float = 2.0,
        batch_size: int = 100,
        mirror_embeddings: bool = True,
        *,
        device: torch.device | str,
        **kwargs: Any,
    ):
        """``driver`` injects any object with
        ``session(database=...) -> ctx`` yielding ``run(query, **params)``
        — the real ``neo4j.GraphDatabase.driver`` by default, a fake in
        tests (no server exists in this environment, so the adapter's
        behavior is pinned against a protocol-level double)."""
        if driver is None:
            try:
                import neo4j
            except ImportError as exc:
                raise ImportError(
                    "the neo4j driver is not installed; use ArrayGraphStore "
                    "(rag_arc_tpu_torch.graph.store) instead"
                ) from exc
            driver = neo4j.GraphDatabase.driver(uri, auth=(user, password))
        super().__init__(embeddings, device=device, **kwargs)
        self._driver = driver
        self._database = database
        self.max_retries = max_retries
        self._retry_wait_base = retry_wait_base
        self.batch_size = max(1, int(batch_size))
        self.mirror_embeddings = bool(mirror_embeddings)
        self._node_buf: Dict[str, List[Dict[str, Any]]] = {}
        self._edge_buf: Dict[str, List[Dict[str, Any]]] = {}
        self._pending = 0
        self._ensure_schema()

    # -- transport ----------------------------------------------------------

    @staticmethod
    def _retryable_exceptions() -> tuple:
        try:
            import neo4j.exceptions as nx

            return (nx.ServiceUnavailable, nx.TransientError, ConnectionError)
        except ImportError:
            return (ConnectionError,)

    def _run(self, query: str, **params: Any):
        retryable = self._retryable_exceptions()
        last: Optional[Exception] = None
        for attempt in range(self.max_retries):
            try:
                with self._driver.session(database=self._database) as session:
                    return list(session.run(query, **params))
            except retryable as exc:
                last = exc
                wait = min(self._retry_wait_base * (2.0**attempt), 10.0)
                logger.warning(
                    "neo4j transient failure (attempt %d/%d): %s; retry in %.1fs",
                    attempt + 1,
                    self.max_retries,
                    exc,
                    wait,
                )
                time.sleep(wait)
        raise ConnectionError(
            f"neo4j unreachable after {self.max_retries} tries"
        ) from last

    def _ensure_schema(self) -> None:
        for stmt in _CONSTRAINTS:
            self._run(stmt)
        dim = int(getattr(self.embeddings, "dim", 0) or 0)
        if dim:
            for kind, label in _LABELS.items():
                self._run(
                    _VECTOR_INDEX.format(
                        name=f"{kind}_embedding", label=label, dim=dim
                    )
                )

    # -- buffered mirrored mutations -----------------------------------------

    def upsert_node(self, node: GraphNode) -> GraphNode:
        merged = super().upsert_node(node)
        label = _LABELS[merged.kind]
        self._node_buf.setdefault(label, []).append(
            {
                "key": merged.key,
                "content": merged.content,
                "props": _scalar_props(merged.properties),
            }
        )
        self._pending += 1
        if self._pending >= self.batch_size:
            self.flush()
        return merged

    def add_edge(self, edge: GraphEdge) -> bool:
        added = super().add_edge(edge)
        if added:
            self._edge_buf.setdefault(edge.edge_type, []).append(
                {
                    "src": edge.src,
                    "dst": edge.dst,
                    "props": _scalar_props(edge.properties, allow_list=False),
                }
            )
            self._pending += 1
            if self._pending >= self.batch_size:
                self.flush()
        return added

    def flush(self) -> None:
        """Write buffered mutations: one ``UNWIND`` statement per label /
        edge type (nodes first — edges MATCH their endpoints).

        Failure-safe: anything not yet written goes BACK into the buffers
        before the exception propagates — a transient outage past the
        retry budget must not silently drop mirror rows (the array store
        keeps them, and a dropped batch would diverge the two forever).
        """
        node_buf, self._node_buf = self._node_buf, {}
        edge_buf, self._edge_buf = self._edge_buf, {}
        self._pending = 0
        try:
            while node_buf:
                label, rows = next(iter(node_buf.items()))
                self._run(
                    f"UNWIND $rows AS row MERGE (n:{label} {{key: row.key}}) "
                    "SET n.content = row.content, n += row.props",
                    rows=rows,
                )
                del node_buf[label]
            while edge_buf:
                edge_type, rows = next(iter(edge_buf.items()))
                self._run(
                    "UNWIND $rows AS row "
                    "MATCH (a {key: row.src}), (b {key: row.dst}) "
                    f"MERGE (a)-[r:{edge_type}]->(b) SET r += row.props",
                    rows=rows,
                )
                del edge_buf[edge_type]
        except Exception:
            # re-queue the unwritten remainder AHEAD of rows buffered since
            for label, rows in node_buf.items():
                self._node_buf.setdefault(label, [])[:0] = rows
                self._pending += len(rows)
            for edge_type, rows in edge_buf.items():
                self._edge_buf.setdefault(edge_type, [])[:0] = rows
                self._pending += len(rows)
            raise

    def store_hyperrag_graph(self, *args: Any, **kwargs: Any):
        stats = super().store_hyperrag_graph(*args, **kwargs)
        self.flush()
        return stats

    def generate_embeddings(self) -> int:
        """Backfill embeddings on the array store, then mirror the new
        vectors into ``n.embedding`` (batches of ``batch_size``) so the
        Neo4j-side vector indexes serve the same vectors the store does."""
        total = super().generate_embeddings()
        if not (self.mirror_embeddings and total):
            return total
        self.flush()  # nodes must exist before SET n.embedding
        for kind, label in _LABELS.items():
            index = self._indexes.get(kind)
            positions = self._positions.get(kind, {})
            if index is None or not positions:
                continue
            items = sorted(positions.items(), key=lambda kv: kv[1])
            for start in range(0, len(items), self.batch_size):
                chunk = items[start : start + self.batch_size]
                vecs = index.take(np.asarray([p for _, p in chunk]))
                rows = [
                    {"key": key, "embedding": vec.tolist()}
                    for (key, _), vec in zip(chunk, vecs)
                ]
                self._run(
                    f"UNWIND $rows AS row MATCH (n:{label} {{key: row.key}}) "
                    "SET n.embedding = row.embedding",
                    rows=rows,
                )
        return total

    def delete_graph_data(self) -> None:
        super().delete_graph_data()
        self._node_buf, self._edge_buf, self._pending = {}, {}, 0
        self._run("MATCH (n) DETACH DELETE n")

    # -- ops ---------------------------------------------------------------------

    def health_check(self) -> Dict[str, Any]:
        base = super().health_check()
        try:
            self.flush()
            record = self._run("RETURN 1 AS ok")[0]
            base["neo4j"] = "ok" if record["ok"] == 1 else "degraded"
        except Exception as exc:  # noqa: BLE001 — health check must not raise
            base["neo4j"] = f"unreachable: {exc}"
            base["status"] = "degraded"
        base["backend"] = "array+neo4j"
        base["pending_writes"] = self._pending
        return base

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._driver.close()
