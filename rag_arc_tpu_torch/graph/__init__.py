"""GraphRAG: the HyperRAG extractor and the array graph store (counterpart
of ``rag_arc_tpu/graph``, with the same exports)."""

from rag_arc_tpu_torch.graph.extractor import GraphExtractorBase
from rag_arc_tpu_torch.graph.hyperrag import HyperRAGGraphExtractor
from rag_arc_tpu_torch.graph.schema import (
    Entity,
    EntityRelation,
    Event,
    EventRelation,
    KnowledgeStructure,
)
from rag_arc_tpu_torch.graph.store import ArrayGraphStore

__all__ = [
    "Event",
    "Entity",
    "EventRelation",
    "EntityRelation",
    "KnowledgeStructure",
    "GraphExtractorBase",
    "HyperRAGGraphExtractor",
    "ArrayGraphStore",
]
