"""HyperRAG event/entity graph extractor.

The port's own copy of ``rag_arc_tpu/graph/hyperrag.py``, its behaviour unchanged,
so the port imports nothing of the JAX package.

Parity with the reference's ``HyperRAGGraphExtractor``
(``core/file_management/extractor/event_GraphExtractor.py:14``): structured
extraction via ``parse_chat(KnowledgeStructure)`` with a ``{text}``/
``{history}`` prompt; round loop stopping when a round adds no new
events/entities; dedup keyed on event id and entity_name; event relations
resolved id → content; clean pass = regex junk-entity prefilter →
LLM keep-list review → relation cleanup (drop dangling / self-loop /
same-name, map ids to names).
"""

from __future__ import annotations

import json
import logging
import re
from typing import Dict, Set

from rag_arc_tpu_torch.graph.extractor import ExtractionResult, GraphExtractorBase
from rag_arc_tpu_torch.graph.prompts import (
    ENTITY_REVIEW_TEMPLATE,
    ExtractionPromptConfig,
)
from rag_arc_tpu_torch.graph.schema import (
    EntityReview,
    KnowledgeStructure,
)
from rag_arc_tpu_torch.llm.base import LLMBase
from rag_arc_tpu_torch.utils.data_model import Document

logger = logging.getLogger(__name__)

# junk-entity prefilter (reference event_GraphExtractor.py:242-312 semantics)
_NUMBERLIKE_RE = re.compile(r"^[\d\s.,:%/+\-—–]+$")
_PRONOUNS = {
    "it", "they", "he", "she", "we", "you", "i", "this", "that", "these",
    "those", "them", "其", "它", "他", "她", "这", "那", "我们", "他们",
}
_STOPWORDS = {
    "the", "a", "an", "and", "or", "of", "to", "in", "on", "for", "with",
    "is", "are", "was", "be", "etc", "等", "的", "了", "和", "与",
}


class HyperRAGGraphExtractor(GraphExtractorBase):
    def __init__(
        self,
        llm: LLMBase,
        prompt: ExtractionPromptConfig | None = None,
        max_rounds: int = 3,
        max_concurrent: int = 100,
        clean: bool = True,
        min_entity_len: int = 2,
    ):
        super().__init__(
            llm=llm, max_rounds=max_rounds, max_concurrent=max_concurrent, clean=clean
        )
        self.prompt = prompt or ExtractionPromptConfig()
        self.min_entity_len = min_entity_len

    # -- extraction ---------------------------------------------------------

    def _history_json(self, history: KnowledgeStructure) -> str:
        slim = {
            "events": [
                {"id": e.id, "content": e.content} for e in history.events
            ],
            "entities": [
                {"entity_name": n.entity_name, "entity_type": n.entity_type}
                for n in history.entities
            ],
        }
        return json.dumps(slim, ensure_ascii=False)

    async def _extract_round(
        self, document: Document, history: KnowledgeStructure, round_idx: int
    ) -> KnowledgeStructure:
        prompt = self.prompt.render(document.content, self._history_json(history))
        return await self.llm.aparse_chat(
            [{"role": "user", "content": prompt}], KnowledgeStructure
        )

    def _merge(
        self, history: KnowledgeStructure, new: KnowledgeStructure
    ) -> tuple[KnowledgeStructure, int]:
        n_new = 0
        # events dedup by CONTENT, not LLM-assigned id: a later round that
        # restarts its E1.. numbering must not have its genuinely-new
        # events silently dropped (which also fired the early-stop). A
        # reused id on new content is re-minted, and that round's
        # relations referencing it are remapped.
        event_keys = {e.content.strip().lower() for e in history.events}
        event_key_to_id = {e.content.strip().lower(): e.id for e in history.events}
        event_ids = {e.id for e in history.events}
        id_remap: dict = {}
        for event in new.events:
            key = event.content.strip().lower()
            if key in event_keys:
                # content-duplicate: the round's OWN numbering may still
                # reference this id in its relations — point it at the
                # kept event, else those relations dangle (or hit
                # whatever unrelated event happens to own the id)
                kept = event_key_to_id[key]
                if event.id != kept:
                    id_remap[event.id] = kept
                continue
            if event.id in event_ids:
                n = len(event_ids) + 1
                while f"E{n}" in event_ids:
                    n += 1
                id_remap[event.id] = f"E{n}"
                event = event.model_copy(update={"id": f"E{n}"})
            history.events.append(event)
            event_ids.add(event.id)
            event_keys.add(key)
            event_key_to_id[key] = event.id
            n_new += 1
        # entities dedup by name — but a re-extracted entity ENRICHES the
        # kept one (later rounds often add descriptions/aliases that
        # entity-merge richness ranking depends on); enrichment does not
        # count toward round progress
        entity_by_key = {
            n.entity_name.strip().lower(): n for n in history.entities
        }
        for entity in new.entities:
            key = entity.entity_name.strip().lower()
            cur = entity_by_key.get(key)
            if cur is None:
                history.entities.append(entity)
                entity_by_key[key] = entity
                n_new += 1
                continue
            if entity.description and not cur.description:
                cur.description = entity.description
            for m in entity.mentions:
                if m not in cur.mentions:
                    cur.mentions.append(m)
        # relations dedup by (head, tail, type); they do NOT count toward
        # round progress (reference stops on no new events/entities)
        seen_ev = {
            (r.head_event, r.tail_event, r.relation_type)
            for r in history.event_relations
        }
        for rel in new.event_relations:
            if rel.head_event in id_remap or rel.tail_event in id_remap:
                rel = rel.model_copy(
                    update={
                        "head_event": id_remap.get(rel.head_event, rel.head_event),
                        "tail_event": id_remap.get(rel.tail_event, rel.tail_event),
                    }
                )
            key = (rel.head_event, rel.tail_event, rel.relation_type)
            if key not in seen_ev:
                history.event_relations.append(rel)
                seen_ev.add(key)
        seen_en = {
            (r.head_entity, r.tail_entity, r.relation_type)
            for r in history.entity_relations
        }
        for rel in new.entity_relations:
            key = (rel.head_entity, rel.tail_entity, rel.relation_type)
            if key not in seen_en:
                history.entity_relations.append(rel)
                seen_en.add(key)
        return history, n_new

    # -- cleaning -----------------------------------------------------------

    @classmethod
    def _is_junk_entity(cls, name: str, min_len: int) -> bool:
        stripped = name.strip()
        low = stripped.lower()
        return (
            len(stripped) < min_len
            or bool(_NUMBERLIKE_RE.match(stripped))
            or low in _PRONOUNS
            or low in _STOPWORDS
        )

    async def _review_entities(self, knowledge: KnowledgeStructure) -> Set[str]:
        """LLM keep-list review (event_GraphExtractor.py:404-459 parity);
        on failure keep everything that survived the regex prefilter."""
        candidates = [
            {
                "entity_name": e.entity_name,
                "entity_type": e.entity_type,
                "description": e.description,
            }
            for e in knowledge.entities
        ]
        if not candidates:
            return set()
        prompt = ENTITY_REVIEW_TEMPLATE.format(
            candidates=json.dumps(candidates, ensure_ascii=False)
        )
        try:
            review = await self.llm.aparse_chat(
                [{"role": "user", "content": prompt}], EntityReview
            )
            keep = {k.strip().lower() for k in review.keep}
            if not keep:  # an empty keep-list is more likely a bad LLM round
                return {e.entity_name.lower() for e in knowledge.entities}
            return keep
        except Exception as exc:  # noqa: BLE001
            logger.warning("entity review failed (%s); keeping prefiltered set", exc)
            return {e.entity_name.lower() for e in knowledge.entities}

    def _resolve_event_relations(self, knowledge: KnowledgeStructure) -> None:
        """Map event-id endpoints to event content
        (event_GraphExtractor.py:178-204 parity) and drop dangling/self
        loops."""
        by_id: Dict[str, str] = {e.id: e.content for e in knowledge.events}
        contents = {e.content for e in knowledge.events}
        cleaned = []
        for rel in knowledge.event_relations:
            head = by_id.get(rel.head_event, rel.head_event)
            tail = by_id.get(rel.tail_event, rel.tail_event)
            if head not in contents or tail not in contents or head == tail:
                continue
            rel.head_event, rel.tail_event = head, tail
            cleaned.append(rel)
        knowledge.event_relations = cleaned

    def _clean_entity_relations(
        self, knowledge: KnowledgeStructure, kept: Set[str]
    ) -> None:
        cleaned = []
        for rel in knowledge.entity_relations:
            head = rel.head_entity.strip()
            tail = rel.tail_entity.strip()
            if (
                head.lower() not in kept
                or tail.lower() not in kept
                or head.lower() == tail.lower()
            ):
                continue
            rel.head_entity, rel.tail_entity = head, tail
            cleaned.append(rel)
        knowledge.entity_relations = cleaned

    async def _clean(self, result: ExtractionResult) -> ExtractionResult:
        knowledge = result.knowledge
        # 1. regex prefilter
        knowledge.entities = [
            e
            for e in knowledge.entities
            if not self._is_junk_entity(e.entity_name, self.min_entity_len)
        ]
        # 2. LLM review
        kept = await self._review_entities(knowledge)
        knowledge.entities = [
            e for e in knowledge.entities if e.entity_name.lower() in kept
        ]
        kept_names = {e.entity_name.strip().lower() for e in knowledge.entities}
        # 3. relation cleanup
        self._resolve_event_relations(knowledge)
        self._clean_entity_relations(knowledge, kept_names)
        # participants must reference kept entities (strip: padded
        # surface forms must not sever the link)
        for event in knowledge.events:
            event.participants = [
                p for p in event.participants if p.strip().lower() in kept_names
            ]
        return result
