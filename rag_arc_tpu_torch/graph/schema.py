"""GraphRAG LLM-output and node schemas.

The port's own copy of ``rag_arc_tpu/graph/schema.py``, its behaviour unchanged,
so the port imports nothing of the JAX package.

Consolidates the reference's three near-duplicate schema sets
(``encapsulation/utils/pydantic_schema.py``, ``graph_schema.py``, and the
domain copy in ``examples/graph_extract/promt.py`` — SURVEY.md §2.9) into
one canonical set: id-regex-validated events/entities/relations (the
``graph_schema.py:7,23,41-44`` pattern), a ``KnowledgeStructure`` container
used as the extractor's structured-output format, and the node/relation
types the graph store persists.
"""

from __future__ import annotations

from typing import Any, Dict, List, Literal, Optional

from pydantic import BaseModel, Field, field_validator

EVENT_ID_PATTERN = r"^E\d+$"
ENTITY_ID_PATTERN = r"^N\d+$"


class Event(BaseModel):
    id: str = Field(pattern=EVENT_ID_PATTERN, description="event id like E1")
    content: str = Field(description="self-contained description of the event")
    event_type: Optional[str] = Field(default=None, description="domain event type")
    participants: List[str] = Field(
        default_factory=list, description="entity names participating in the event"
    )


class Entity(BaseModel):
    id: Optional[str] = Field(
        default=None, pattern=ENTITY_ID_PATTERN, description="entity id like N1"
    )
    entity_name: str = Field(description="canonical surface name")
    entity_type: Optional[str] = Field(default=None, description="domain entity type")
    description: Optional[str] = Field(default=None)
    mentions: List[str] = Field(
        default_factory=list, description="alternative surface forms"
    )

    @field_validator("entity_name")
    @classmethod
    def _non_empty(cls, v: str) -> str:
        if not v.strip():
            raise ValueError("entity_name must be non-empty")
        return v.strip()


class EventRelation(BaseModel):
    head_event: str = Field(description="head event id or content")
    tail_event: str = Field(description="tail event id or content")
    relation_type: str = Field(default="RELATED", description="relation label")


class EntityRelation(BaseModel):
    head_entity: str = Field(description="head entity name")
    tail_entity: str = Field(description="tail entity name")
    relation_type: str = Field(default="RELATED", description="relation label")


class KnowledgeStructure(BaseModel):
    """The extractor's structured-output container (one round's result)."""

    events: List[Event] = Field(default_factory=list)
    entities: List[Entity] = Field(default_factory=list)
    event_relations: List[EventRelation] = Field(default_factory=list)
    entity_relations: List[EntityRelation] = Field(default_factory=list)

    def is_empty(self) -> bool:
        return not (
            self.events or self.entities or self.event_relations or self.entity_relations
        )


class EntityReview(BaseModel):
    """LLM clean-pass verdict: entity names worth keeping."""

    keep: List[str] = Field(default_factory=list, description="entity names to keep")


# -- store-side node/edge records ------------------------------------------

NodeKind = Literal["chunk", "event", "entity"]

EDGE_TYPES = (
    "CONTAINS",  # chunk → event
    "MENTIONS",  # chunk → entity
    "PARTICIPATES_IN",  # entity → event
    "ENTITY_RELATION",  # entity → entity
    "EVENT_RELATION",  # event → event
)


class GraphNode(BaseModel):
    key: str  # unique within its kind (chunk hash / event content hash / entity name)
    kind: NodeKind
    content: str
    properties: Dict[str, Any] = Field(default_factory=dict)


class GraphEdge(BaseModel):
    src: str
    dst: str
    edge_type: str
    properties: Dict[str, Any] = Field(default_factory=dict)

    @field_validator("edge_type")
    @classmethod
    def _known(cls, v: str) -> str:
        if v not in EDGE_TYPES:
            raise ValueError(f"edge_type must be one of {EDGE_TYPES}, got {v!r}")
        return v


class Triplet(BaseModel):
    head: str
    relation: str
    tail: str


class PydanticUtils:
    """Convenience helpers over arbitrary pydantic models (parity with the
    reference's ``encapsulation/utils/pydantic_schema.py:165-228``)."""

    @staticmethod
    def to_dict(obj: BaseModel) -> Dict[str, Any]:
        return obj.model_dump()

    @staticmethod
    def from_dict(model_cls: type, data: Dict[str, Any]) -> BaseModel:
        return model_cls.model_validate(data)

    @staticmethod
    def safe_get_attr(obj: Any, name: str, default: Any = None) -> Any:
        try:
            return getattr(obj, name, default)
        except Exception:  # noqa: BLE001 — defensive accessor by contract
            return default
