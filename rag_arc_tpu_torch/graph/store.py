"""Array-backed graph store (counterpart of
``rag_arc_tpu/graph/store.py::ArrayGraphStore``).

Nodes and typed edges live in host dicts; node embeddings live in
per-kind ``DeviceFlatIndex`` tensors on the store's device (f32 cosine,
as in the JAX package), and the two graph-ML passes the reference
outsourced to Neo4j GDS run on the flat index's search:

- **entity merge** (ref ``Base_Neo4j.py:386-950``): instead of an O(N²)
  sklearn cosine pass + GDS Louvain + APOC migration, the similarity graph
  comes from a batched top-k self-search at threshold 0.95 (4,096
  queries a search); clusters are connected components (union-find) over
  those edges; the richest entity in each cluster wins and
  edges/mentions migrate to it.
- **event disambiguation** (ref ``event_graphrag_neo4j.py:600-673``):
  GDS KNN (topK=10, cutoff 0.85) becomes the same top-k; SIMILAR pairs
  fold into EVENT_RELATION edges.

On a CUDA store a chunk whose (B, capacity) f32 score matrix exceeds the
index's ``SCORE_BYTES_BUDGET`` takes the two-level path: one launch of
``csrc/subtile_max.cu`` (f32 mode) and one of ``csrc/subtile_select.cu``;
smaller chunks take the direct product + top-k.

The store pipeline (``store_hyperrag_graph``) mirrors the reference's
10-step flow (``event_graphrag_neo4j.py:80-215``): chunk dedup → node
upserts (merging mention/description lists) → relation edges (event
relations matched by content, ``:441-449``) → link edges → embedding
backfill in batches of 100 (``Base_Neo4j.py:161-384``) → entity merge →
event disambiguation. Everything is idempotent: keys are content hashes /
canonical names and upserts are merges.

Snapshots keep the JAX package's format (``rag_arc_tpu.graph.v1``: JSON
nodes and edges, ``<path>.emb_<kind>.npy`` f32 sidecars), so either
package loads the other's. The host spans ``graph.search`` (the
self-search), ``graph.pairs`` (the host pair loop) and ``graph.merge``
(union-find and the edge rebuild) time the merge (``utils/tracing.py``).
"""

from __future__ import annotations

import json
import logging
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from rag_arc_tpu_torch.graph.extractor import ExtractionResult
from rag_arc_tpu_torch.graph.schema import GraphEdge, GraphNode
from rag_arc_tpu_torch.index.flat import DeviceFlatIndex
from rag_arc_tpu_torch.models.embeddings import Embeddings
from rag_arc_tpu_torch.utils.data_model import Document
from rag_arc_tpu_torch.utils.tracing import stage

logger = logging.getLogger(__name__)

KINDS = ("chunk", "event", "entity")
SEARCH_CHUNK = 4096  # queries a self-search of _similar_pairs


class _UnionFind:
    def __init__(self):
        self.parent: Dict[str, str] = {}

    def find(self, x: str) -> str:
        self.parent.setdefault(x, x)
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: str, b: str) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


class ArrayGraphStore:
    def __init__(
        self,
        embeddings: Embeddings,
        mesh=None,
        merge_threshold: float = 0.95,
        knn_top_k: int = 10,
        knn_cutoff: float = 0.85,
        embed_batch: int = 100,
        *,
        device: torch.device | str,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "a graph store over a device mesh is not ported yet (ROADMAP Queue 1 [#15])"
            )
        self.embeddings = embeddings
        self.device = torch.device(device)
        self.merge_threshold = merge_threshold
        self.knn_top_k = knn_top_k
        self.knn_cutoff = knn_cutoff
        self.embed_batch = embed_batch

        self.nodes: Dict[str, Dict[str, GraphNode]] = {k: {} for k in KINDS}
        self.edges: List[GraphEdge] = []
        self._edge_keys: Set[Tuple[str, str, str, str]] = set()
        # adjacency: node key -> indexes into self.edges (both directions),
        # so neighbors/degree/entity-chunk walks are O(deg), not O(E)
        self._adj: Dict[str, List[int]] = defaultdict(list)
        # embedding indexes: one per kind, lazily sized to the embedder dim
        self._indexes: Dict[str, Optional[DeviceFlatIndex]] = {k: None for k in KINDS}
        self._positions: Dict[str, Dict[str, int]] = {k: {} for k in KINDS}

    # -- node/edge primitives ----------------------------------------------

    def upsert_node(self, node: GraphNode) -> GraphNode:
        existing = self.nodes[node.kind].get(node.key)
        if existing is None:
            self.nodes[node.kind][node.key] = node
            return node
        # merge list-valued properties (mentions/descriptions/sources),
        # mirroring the reference's mention upsert (:324-371)
        for key, value in node.properties.items():
            if isinstance(value, list):
                merged = list(existing.properties.get(key, []))
                for item in value:
                    if item not in merged:
                        merged.append(item)
                existing.properties[key] = merged
            elif value is not None and not existing.properties.get(key):
                existing.properties[key] = value
        return existing

    def add_edge(self, edge: GraphEdge) -> bool:
        key = (edge.edge_type, edge.src, edge.dst, str(edge.properties.get("relation_type", "")))
        if key in self._edge_keys:
            return False
        self._edge_keys.add(key)
        idx = len(self.edges)
        self.edges.append(edge)
        self._adj[edge.src].append(idx)
        if edge.dst != edge.src:
            self._adj[edge.dst].append(idx)
        return True

    def neighbors(
        self, kind: str, key: str, edge_type: Optional[str] = None
    ) -> List[Tuple[str, GraphEdge]]:
        out = []
        for idx in self._adj.get(key, ()):
            e = self.edges[idx]
            if edge_type and e.edge_type != edge_type:
                continue
            out.append((e.dst if e.src == key else e.src, e))
        return out

    def degree(self, key: str) -> int:
        return len(self._adj.get(key, ()))

    # -- ingestion pipeline --------------------------------------------------

    def filter_existing_chunks(self, documents: Sequence[Document]) -> List[Document]:
        """Idempotence guard (Base_Neo4j.py:109-158 parity): drop documents
        whose content hash is already stored."""
        fresh = []
        for doc in documents:
            if doc.content_hash() not in self.nodes["chunk"]:
                fresh.append(doc)
        if len(fresh) < len(documents):
            logger.info(
                "filtered %d already-stored chunks", len(documents) - len(fresh)
            )
        return fresh

    def store_hyperrag_graph(
        self, results: Sequence[ExtractionResult]
    ) -> Dict[str, Any]:
        # 1-2: chunks
        for res in results:
            doc = res.document
            self.upsert_node(
                GraphNode(
                    key=doc.content_hash(),
                    kind="chunk",
                    content=doc.content,
                    properties={"doc_id": doc.id, **doc.metadata.get("source", {})}
                    if isinstance(doc.metadata.get("source"), dict)
                    else {"doc_id": doc.id},
                )
            )
        # 3: entities (merge mentions/descriptions)
        for res in results:
            for ent in res.knowledge.entities:
                self.upsert_node(
                    GraphNode(
                        key=ent.entity_name.lower(),
                        kind="entity",
                        content=ent.entity_name,
                        properties={
                            "entity_type": ent.entity_type,
                            "descriptions": [ent.description] if ent.description else [],
                            "mentions": list(ent.mentions),
                            "sources": [res.document.content_hash()],
                        },
                    )
                )
        # 4: events (keyed by content hash — event ids are per-document)
        event_key_by_content: Dict[str, str] = {}
        for res in results:
            for ev in res.knowledge.events:
                key = Document(content=ev.content).content_hash()
                event_key_by_content[ev.content] = key
                self.upsert_node(
                    GraphNode(
                        key=key,
                        kind="event",
                        content=ev.content,
                        properties={
                            "event_type": ev.event_type,
                            "sources": [res.document.content_hash()],
                        },
                    )
                )
        # 5: entity relations
        for res in results:
            for rel in res.knowledge.entity_relations:
                head, tail = rel.head_entity.lower(), rel.tail_entity.lower()
                if head in self.nodes["entity"] and tail in self.nodes["entity"]:
                    self.add_edge(
                        GraphEdge(
                            src=head,
                            dst=tail,
                            edge_type="ENTITY_RELATION",
                            properties={"relation_type": rel.relation_type},
                        )
                    )
        # 6: event relations — endpoints matched by content (ref :441-449),
        # falling back to the extractor's per-document E-ids: with
        # clean=False the relations still hold raw ids, and content-only
        # matching silently dropped EVERY event relation
        for res in results:
            key_by_id = {
                ev.id: event_key_by_content.get(ev.content)
                for ev in res.knowledge.events
            }
            for rel in res.knowledge.event_relations:
                head = event_key_by_content.get(rel.head_event) or key_by_id.get(
                    rel.head_event
                )
                tail = event_key_by_content.get(rel.tail_event) or key_by_id.get(
                    rel.tail_event
                )
                if head and tail and head != tail:
                    self.add_edge(
                        GraphEdge(
                            src=head,
                            dst=tail,
                            edge_type="EVENT_RELATION",
                            properties={"relation_type": rel.relation_type},
                        )
                    )
        # 7: link edges
        for res in results:
            chunk_key = res.document.content_hash()
            for ev in res.knowledge.events:
                ev_key = event_key_by_content[ev.content]
                self.add_edge(
                    GraphEdge(src=chunk_key, dst=ev_key, edge_type="CONTAINS")
                )
                for participant in ev.participants:
                    # strip: whitespace-padded participant strings would
                    # silently sever the PARTICIPATES_IN edge
                    p_key = participant.strip().lower()
                    if p_key in self.nodes["entity"]:
                        self.add_edge(
                            GraphEdge(
                                src=p_key, dst=ev_key, edge_type="PARTICIPATES_IN"
                            )
                        )
            for ent in res.knowledge.entities:
                self.add_edge(
                    GraphEdge(
                        src=chunk_key,
                        dst=ent.entity_name.lower(),
                        edge_type="MENTIONS",
                    )
                )
        # 8: embedding backfill
        self.generate_embeddings()
        # 9: entity merge
        merged = self.merge_duplicate_entities()
        # 10: event disambiguation
        similar = self.disambiguate_events()
        stats = self.get_graph_statistics()
        stats["entities_merged"] = merged
        stats["similar_event_pairs"] = similar
        return stats

    # -- embeddings -----------------------------------------------------------

    def _index_for(self, kind: str, dim: int) -> DeviceFlatIndex:
        index = self._indexes[kind]
        if index is None:
            index = DeviceFlatIndex(dim=dim, metric="cosine", device=self.device)
            self._indexes[kind] = index
        return index

    def generate_embeddings(self) -> int:
        """Embed nodes lacking vectors, in batches (Base_Neo4j.py:161-384
        lazy-backfill parity; empty-content nodes are skipped the way the
        reference sentinels them)."""
        total = 0
        for kind in KINDS:
            pending = [
                key
                for key, node in self.nodes[kind].items()
                if key not in self._positions[kind] and node.content.strip()
            ]
            for start in range(0, len(pending), self.embed_batch):
                batch = pending[start : start + self.embed_batch]
                vecs = self.embeddings.encode(
                    [self.nodes[kind][k].content for k in batch]
                )
                index = self._index_for(kind, vecs.shape[1])
                positions = index.add(vecs)
                for key, pos in zip(batch, positions):
                    self._positions[kind][key] = int(pos)
                total += len(batch)
        return total

    def _key_by_position(self, kind: str) -> Dict[int, str]:
        return {pos: key for key, pos in self._positions[kind].items()}

    def _similar_pairs(
        self, kind: str, threshold: float, top_k: int
    ) -> List[Tuple[str, str, float]]:
        """All (a, b, score) pairs with cosine ≥ threshold, via one batched
        device search of every node vector against the kind's index."""
        if self._indexes[kind] is None or len(self._positions[kind]) < 2:
            return []
        with stage("graph.search"):
            keys, scores, hits = self._self_search(kind, top_k)
        with stage("graph.pairs"):
            return self._pairs_from_hits(kind, keys, scores, hits, threshold)

    def _self_search(
        self, kind: str, top_k: int
    ) -> Tuple[List[str], np.ndarray, np.ndarray]:
        """(keys, scores, hits): every node vector of the kind searched
        against its index for its top_k + 1 (itself included)."""
        index = self._indexes[kind]
        positions = self._positions[kind]
        keys = list(positions)
        vecs = index.take(np.asarray([positions[k] for k in keys]))
        kq = min(top_k + 1, len(keys))
        # sub-batch the all-nodes self-search in SEARCH_CHUNK queries, as
        # the JAX package does, so both packages take the same search path
        # (direct or two-level) for every chunk
        parts = [
            index.search(vecs[s0 : s0 + SEARCH_CHUNK], kq)
            for s0 in range(0, len(keys), SEARCH_CHUNK)
        ]
        return (
            keys,
            np.concatenate([s for s, _ in parts]),
            np.concatenate([h for _, h in parts]),
        )

    def _pairs_from_hits(
        self, kind: str, keys: List[str], scores: np.ndarray, hits: np.ndarray,
        threshold: float,
    ) -> List[Tuple[str, str, float]]:
        """The host pair loop: hits at or above ``threshold``, the self-match
        skipped, each unordered pair once in first-seen (row-major) order,
        as the JAX package's loop gives them. The hit filter runs in numpy
        with the loop's own comparisons (f32 score against the threshold)."""
        by_pos = self._key_by_position(kind)
        rows, cols = np.nonzero((hits >= 0) & ~(scores < threshold))
        seen: Set[Tuple[str, str]] = set()
        out = []
        for i, pos, score in zip(
            rows.tolist(), hits[rows, cols].tolist(), scores[rows, cols].tolist()
        ):
            key = keys[i]
            other = by_pos.get(pos)
            if other is None or other == key:
                continue
            a, b = sorted((key, other))
            if (a, b) not in seen:  # dedup symmetric pairs
                seen.add((a, b))
                out.append((a, b, score))
        return out

    # -- entity merge ----------------------------------------------------------

    def _entity_richness(self, key: str) -> Tuple[int, int, int]:
        node = self.nodes["entity"][key]
        n_desc = sum(len(d or "") for d in node.properties.get("descriptions", []))
        n_mentions = len(node.properties.get("mentions", []))
        return (n_desc, n_mentions, self.degree(key))

    def merge_duplicate_entities(self) -> int:
        """Similarity-clustered merge (threshold 0.95) keeping the richest
        entity per cluster; replaces GDS Louvain + APOC migration. All
        clusters apply in ONE edge-list rebuild (the r1 version rebuilt the
        whole edge list per merged entity — O(V·E) on merge-heavy graphs)."""
        pairs = self._similar_pairs("entity", self.merge_threshold, self.knn_top_k)
        if not pairs:
            return 0
        with stage("graph.merge"):
            uf = _UnionFind()
            for a, b, _ in pairs:
                uf.union(a, b)
            clusters: Dict[str, List[str]] = defaultdict(list)
            for key in {k for pair in pairs for k in pair[:2]}:
                clusters[uf.find(key)].append(key)
            redirect: Dict[str, str] = {}
            for members in clusters.values():
                if len(members) < 2:
                    continue
                winner = max(members, key=self._entity_richness)
                for loser in members:
                    if loser != winner:
                        redirect[loser] = winner
            return self._apply_entity_merges(redirect)

    def _apply_entity_merges(self, redirect: Dict[str, str]) -> int:
        """Fold loser entities into winners: merge properties, re-point all
        edges in a single pass, rebuild the dedup set + adjacency once,
        and tombstone loser index rows in one batch."""
        if not redirect:
            return 0
        for loser, winner in redirect.items():
            loser_node = self.nodes["entity"].pop(loser, None)
            if loser_node is None:
                continue
            winner_node = self.nodes["entity"][winner]
            for prop in ("descriptions", "mentions", "sources"):
                merged = list(winner_node.properties.get(prop, []))
                for item in loser_node.properties.get(prop, []):
                    if item not in merged:
                        merged.append(item)
                winner_node.properties[prop] = merged
            mentions = winner_node.properties.setdefault("mentions", [])
            if (
                loser_node.content not in mentions
                and loser_node.content != winner_node.content
            ):
                mentions.append(loser_node.content)
        # single rebuild: re-point, drop new self-loops, dedup
        old_edges = self.edges
        self.edges = []
        self._edge_keys.clear()
        self._adj.clear()
        for e in old_edges:
            src = redirect.get(e.src, e.src)
            dst = redirect.get(e.dst, e.dst)
            if src == dst and e.edge_type in ("ENTITY_RELATION", "EVENT_RELATION"):
                continue
            if src == e.src and dst == e.dst:
                self.add_edge(e)
            else:
                self.add_edge(
                    GraphEdge(
                        src=src, dst=dst, edge_type=e.edge_type,
                        properties=e.properties,
                    )
                )
        # tombstone loser index rows in one batch
        dead = [
            pos
            for loser in redirect
            if (pos := self._positions["entity"].pop(loser, None)) is not None
        ]
        if dead and self._indexes["entity"] is not None:
            self._indexes["entity"].mark_deleted(np.asarray(dead))
        return len(redirect)

    # -- event disambiguation ----------------------------------------------------

    def disambiguate_events(self) -> int:
        """KNN SIMILAR pairs folded into EVENT_RELATION edges
        (event_graphrag_neo4j.py:600-673 parity)."""
        pairs = self._similar_pairs("event", self.knn_cutoff, self.knn_top_k)
        added = 0
        for a, b, score in pairs:
            if self.add_edge(
                GraphEdge(
                    src=a,
                    dst=b,
                    edge_type="EVENT_RELATION",
                    properties={"relation_type": "SIMILAR_TO", "score": score},
                )
            ):
                added += 1
        return added

    # -- retrieval over the graph -------------------------------------------------

    def search_nodes(
        self, kind: str, query: str, k: int = 10
    ) -> List[Tuple[GraphNode, float]]:
        """Vector search over a node kind (what Neo4j vector indexes did,
        event_graphrag_neo4j.py:266-300)."""
        index = self._indexes[kind]
        if index is None or index.n_active == 0:
            return []
        vec = self.embeddings.encode([query])
        scores, positions = index.search(vec, k)
        by_pos = self._key_by_position(kind)
        out = []
        for score, pos in zip(scores[0], positions[0]):
            key = by_pos.get(int(pos)) if pos >= 0 else None
            if key is not None and key in self.nodes[kind]:
                out.append((self.nodes[kind][key], float(score)))
        return out

    def entity_linked_chunks(self, query: str, k: int = 10, entity_k: int = 5) -> List[Document]:
        """GraphRAG retrieval: find entities near the query, walk MENTIONS
        edges back to chunks, rank chunks by entity hit count (BASELINE
        config 5's entity-linked chunk index)."""
        entities = self.search_nodes("entity", query, entity_k)
        chunk_scores: Dict[str, float] = defaultdict(float)
        for node, score in entities:
            for idx in self._adj.get(node.key, ()):
                e = self.edges[idx]
                if e.edge_type == "MENTIONS" and e.dst == node.key:
                    chunk_scores[e.src] += score
        ranked = sorted(chunk_scores.items(), key=lambda kv: -kv[1])[:k]
        docs = []
        for key, score in ranked:
            chunk = self.nodes["chunk"].get(key)
            if chunk is not None:
                docs.append(
                    Document(
                        content=chunk.content,
                        metadata={"graph_score": score, "chunk_key": key},
                        id=chunk.properties.get("doc_id"),
                    )
                )
        return docs

    # -- ops / observability -------------------------------------------------------

    def get_graph_statistics(self) -> Dict[str, Any]:
        edge_counts = defaultdict(int)
        for e in self.edges:
            edge_counts[e.edge_type] += 1
        return {
            "chunks": len(self.nodes["chunk"]),
            "events": len(self.nodes["event"]),
            "entities": len(self.nodes["entity"]),
            "contains_edges": edge_counts["CONTAINS"],
            "mentions_edges": edge_counts["MENTIONS"],
            "participates_edges": edge_counts["PARTICIPATES_IN"],
            "entity_relation_edges": edge_counts["ENTITY_RELATION"],
            "event_relation_edges": edge_counts["EVENT_RELATION"],
            "total_nodes": sum(len(self.nodes[k]) for k in KINDS),
            "total_edges": len(self.edges),
            "chunks_with_embeddings": len(self._positions["chunk"]),
            "events_with_embeddings": len(self._positions["event"]),
            "entities_with_embeddings": len(self._positions["entity"]),
        }

    def delete_graph_data(self) -> None:
        self.nodes = {k: {} for k in KINDS}
        self.edges = []
        self._edge_keys.clear()
        self._adj.clear()
        self._indexes = {k: None for k in KINDS}
        self._positions = {k: {} for k in KINDS}

    def health_check(self) -> Dict[str, Any]:
        return {
            "status": "ok",
            "backend": "array",
            "embeddings": type(self.embeddings).__name__,
            **self.get_graph_statistics(),
        }

    # -- persistence -----------------------------------------------------------------

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "format": "rag_arc_tpu.graph.v1",
            "nodes": {
                kind: {k: n.model_dump() for k, n in nodes.items()}
                for kind, nodes in self.nodes.items()
            },
            "edges": [e.model_dump() for e in self.edges],
            "emb_keys": {},
        }
        # snapshot the per-kind embedding vectors too: re-encoding every
        # node at load is hours of encoder work at 1M nodes for data the
        # store already holds
        for kind, index in self._indexes.items():
            positions = self._positions.get(kind) or {}
            if index is None or not positions:
                continue
            keys = list(positions.keys())
            vecs = index.take(np.asarray([positions[k] for k in keys]))
            np.save(f"{path}.emb_{kind}.npy", vecs.astype(np.float32))
            payload["emb_keys"][kind] = keys
        path.write_text(json.dumps(payload, ensure_ascii=False), encoding="utf-8")

    def load(self, path: str | Path) -> None:
        path = Path(path)
        payload = json.loads(path.read_text(encoding="utf-8"))
        if payload.get("format") != "rag_arc_tpu.graph.v1":
            raise ValueError(f"unrecognized graph snapshot format in {path}")
        self.delete_graph_data()
        for kind, nodes in payload["nodes"].items():
            for key, node in nodes.items():
                self.nodes[kind][key] = GraphNode.model_validate(node)
        for edge in payload["edges"]:
            self.add_edge(GraphEdge.model_validate(edge))
        # restore snapshotted vectors where present; anything missing (or
        # a legacy snapshot without sidecars) backfills via the encoder
        # a sidecar saved under a different embedder dim must NOT restore:
        # the first query/backfill after load would encode at the current
        # dim and crash against the restored index far from the cause —
        # fall back to re-encoding (slow but consistent) instead
        expect_dim = getattr(self.embeddings, "dim", None)
        for kind, keys in (payload.get("emb_keys") or {}).items():
            sidecar = Path(f"{path}.emb_{kind}.npy")
            if not keys or not sidecar.exists():
                continue
            vecs = np.load(sidecar)
            if expect_dim is not None and vecs.shape[1] != expect_dim:
                logger.warning(
                    "graph snapshot %s sidecar for %r has dim %d but the "
                    "current embedder produces dim %d; re-encoding instead",
                    path, kind, vecs.shape[1], expect_dim,
                )
                continue
            index = self._index_for(kind, vecs.shape[1])
            positions = index.add(vecs)
            for key, pos in zip(keys, positions):
                self._positions[kind][key] = int(pos)
        self.generate_embeddings()
