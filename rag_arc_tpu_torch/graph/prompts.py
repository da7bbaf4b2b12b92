"""GraphRAG extraction prompts.

The port's own copy of ``rag_arc_tpu/graph/prompts.py``, its behaviour unchanged,
so the port imports nothing of the JAX package.

The reference ships a Chinese chain-of-thought prompt specialized to the
civil-service-exam domain (``core/prompts/prompt.py:1-62``) plus a
manufacturing-domain variant (``examples/graph_extract/promt.py``). Here the
prompt is a domain-parameterized template with the same structural rules:
incremental extraction against ``{history}``, self-contained event
descriptions, typed events/entities, and id discipline (E1.., N1..).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

DEFAULT_EVENT_TYPES = ("action", "analysis", "computation", "statement", "process")
DEFAULT_ENTITY_TYPES = ("concept", "method", "object", "organization", "person")

HYPERRAG_EXTRACTION_TEMPLATE = """\
You are a knowledge-graph extraction engine. Extract events and entities \
from the text below, incrementally against the extraction history.

Rules:
1. EVENTS are self-contained statements (id E1, E2, ...): each event's \
content must be understandable without the source text. Allowed event \
types: {event_types}.
2. ENTITIES are salient, reusable concepts (id N1, N2, ...): canonical \
name, type from {entity_types}, a one-sentence description, and any \
alternative surface forms as mentions. Do NOT extract numbers, pronouns, \
dates, or generic words as entities.
3. RELATIONS: event_relations connect event ids (causal/temporal/\
elaboration); entity_relations connect entity names. Every relation \
endpoint must exist in this round's output or in the history.
4. INCREMENTAL: the history below lists what is already extracted. Only \
output NEW events/entities/relations not present in the history. If \
nothing new remains, output empty lists.
5. Participants of each event must be entity names from rule 2.

Extraction history (JSON):
{history}

Text:
{text}
"""


@dataclass
class ExtractionPromptConfig:
    event_types: Sequence[str] = field(default_factory=lambda: DEFAULT_EVENT_TYPES)
    entity_types: Sequence[str] = field(default_factory=lambda: DEFAULT_ENTITY_TYPES)
    template: str = HYPERRAG_EXTRACTION_TEMPLATE

    def render(self, text: str, history_json: str) -> str:
        return self.template.format(
            event_types=", ".join(self.event_types),
            entity_types=", ".join(self.entity_types),
            history=history_json,
            text=text,
        )


ENTITY_REVIEW_TEMPLATE = """\
You review candidate knowledge-graph entities for quality. Keep only \
entities that are specific, reusable domain concepts; drop numbers, \
pronouns, stopwords, fragments, and one-off phrases.

Candidates (JSON list of name/type/description):
{candidates}

Return the names to KEEP.
"""
