"""Deterministic fake LLM.

The port's own copy of ``rag_arc_tpu/llm/fake.py``, its behaviour unchanged, so
the port imports nothing of the JAX package.

SURVEY.md §4 calls for a fake LLM with canned structured outputs so every
LLM-dependent pipeline (graph extraction, query rewrite, reranking prompts)
is CPU-testable with zero network. ``FakeLLM`` is deterministic: the same
messages always produce the same output.

Three layers of control:
- ``responses``: an explicit queue/mapping of canned replies.
- ``responder``: a callback ``(messages, response_format|None) -> Any``.
- default heuristic: echoes a digest of the last user message; for
  ``parse_chat`` it synthesizes a minimal valid instance of the requested
  pydantic schema (lists empty, strings derived from the prompt, numbers 0).
"""

from __future__ import annotations

import hashlib
import typing
from typing import Any, Callable, Dict, List, Optional, Sequence, Type, TypeVar

from pydantic import BaseModel

from rag_arc_tpu_torch.llm.base import LLMBase, Message

T = TypeVar("T", bound=BaseModel)


def synth_instance(model_cls: Type[T], seed_text: str = "") -> T:
    """Build a minimal valid instance of a pydantic model."""
    values: Dict[str, Any] = {}
    for name, fld in model_cls.model_fields.items():
        if not fld.is_required():
            continue
        values[name] = _synth_value(fld.annotation, f"{seed_text}:{name}")
    return model_cls.model_validate(values)


def _synth_value(annotation: Any, seed: str) -> Any:
    origin = typing.get_origin(annotation)
    args = typing.get_args(annotation)
    if annotation is str:
        return f"fake-{hashlib.md5(seed.encode()).hexdigest()[:8]}"
    if annotation is int:
        return 0
    if annotation is float:
        return 0.0
    if annotation is bool:
        return False
    if origin in (list, typing.List):
        return []
    if origin in (dict, typing.Dict):
        return {}
    if origin is typing.Union:
        non_none = [a for a in args if a is not type(None)]
        return _synth_value(non_none[0], seed) if non_none else None
    if origin is typing.Literal:
        return args[0]
    if isinstance(annotation, type) and issubclass(annotation, BaseModel):
        return synth_instance(annotation, seed).model_dump()
    return None


class FakeLLM(LLMBase):
    def __init__(
        self,
        responses: Optional[List[Any]] = None,
        responder: Optional[Callable[[Sequence[Message], Optional[type]], Any]] = None,
        model: str = "fake-llm",
        track_usage: bool = False,
    ):
        super().__init__(model=model, track_usage=track_usage)
        self.responses = list(responses) if responses else []
        self.responder = responder
        self.calls: List[Dict[str, Any]] = []  # inspection for tests

    def _next(self, messages: Sequence[Message], response_format: Optional[type]):
        if self.responses:
            return self.responses.pop(0)
        if self.responder is not None:
            return self.responder(messages, response_format)
        return None

    def chat(self, messages: Sequence[Message], **kwargs: Any) -> str:
        self.validate_input(messages)
        self.calls.append({"kind": "chat", "messages": list(messages)})
        if self.track_usage:
            self.usage.add(sum(len(m["content"]) // 4 for m in messages), 8)
        canned = self._next(messages, None)
        if canned is not None:
            return canned if isinstance(canned, str) else str(canned)
        digest = hashlib.md5(messages[-1]["content"].encode()).hexdigest()[:12]
        return f"fake-completion-{digest}"

    def parse_chat(
        self, messages: Sequence[Message], response_format: Type[T], **kwargs: Any
    ) -> T:
        self.validate_input(messages)
        self.calls.append(
            {
                "kind": "parse_chat",
                "messages": list(messages),
                "format": response_format.__name__,
            }
        )
        if self.track_usage:
            self.usage.add(sum(len(m["content"]) // 4 for m in messages), 16)
        canned = self._next(messages, response_format)
        if canned is not None:
            if isinstance(canned, response_format):
                return canned
            if isinstance(canned, dict):
                return response_format.model_validate(canned)
            if isinstance(canned, str):
                return response_format.model_validate_json(canned)
            raise TypeError(
                f"canned response {type(canned).__name__} does not match "
                f"requested format {response_format.__name__}"
            )
        return synth_instance(response_format, messages[-1]["content"])

    def embed(self, texts: Sequence[str], **kwargs: Any) -> List[List[float]]:
        from rag_arc_tpu_torch.models.embeddings import HashEmbeddings

        return HashEmbeddings(dim=64).embed_documents(list(texts))
