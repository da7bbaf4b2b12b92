"""LLM adapter interface.

The port's own copy of ``rag_arc_tpu/llm/base.py``, its behaviour unchanged, so
the port imports nothing of the JAX package.

Surface parity with the reference's ``LLMBase``
(``encapsulation/llm/base.py:8-206``): ``chat`` / ``stream_chat`` /
``parse_chat(response_format)`` / ``embed`` plus async twins, message
validation, ``format_messages``, ``get_model_info``, and opt-in token-usage
accounting. LLM calls never sit on the retrieval hot path — they serve
ingestion (graph extraction), query rewrite, and generation.
"""

from __future__ import annotations

import asyncio
import threading
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Type, TypeVar

from pydantic import BaseModel

T = TypeVar("T", bound=BaseModel)

Message = Dict[str, str]  # {"role": ..., "content": ...}

VALID_ROLES = ("system", "user", "assistant", "tool")


@dataclass
class UsageStats:
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0
    requests: int = 0
    # the async twins run on a shared 16-worker executor: unlocked +=
    # read-modify-writes lose updates under asyncio.gather fan-out
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def add(self, prompt: int, completion: int) -> None:
        with self._lock:
            self.prompt_tokens += prompt
            self.completion_tokens += completion
            self.total_tokens += prompt + completion
            self.requests += 1

    def as_dict(self) -> Dict[str, int]:
        return {
            "prompt_tokens": self.prompt_tokens,
            "completion_tokens": self.completion_tokens,
            "total_tokens": self.total_tokens,
            "requests": self.requests,
        }


class LLMBase(ABC):
    _executor: Optional[ThreadPoolExecutor] = None

    def __init__(
        self,
        model: str,
        temperature: float = 0.0,
        max_tokens: Optional[int] = None,
        track_usage: bool = False,
    ):
        self.model = model
        self.temperature = temperature
        self.max_tokens = max_tokens
        self.track_usage = track_usage
        self.usage = UsageStats()

    # -- required sync surface -------------------------------------------

    @abstractmethod
    def chat(self, messages: Sequence[Message], **kwargs: Any) -> str: ...

    @abstractmethod
    def parse_chat(
        self, messages: Sequence[Message], response_format: Type[T], **kwargs: Any
    ) -> T:
        """Structured output: returns a validated response_format instance."""

    def stream_chat(self, messages: Sequence[Message], **kwargs: Any) -> Iterator[str]:
        """Default streaming = yield the whole completion once."""
        yield self.chat(messages, **kwargs)

    def embed(self, texts: Sequence[str], **kwargs: Any) -> List[List[float]]:
        raise NotImplementedError(f"{type(self).__name__} does not provide embeddings")

    # -- validation / formatting ------------------------------------------

    @staticmethod
    def validate_input(messages: Sequence[Message]) -> None:
        if not messages:
            raise ValueError("messages must be non-empty")
        for m in messages:
            if not isinstance(m, dict) or "role" not in m or "content" not in m:
                raise ValueError(f"malformed message {m!r}: need role and content")
            if m["role"] not in VALID_ROLES:
                raise ValueError(f"invalid role {m['role']!r}, expected {VALID_ROLES}")

    @staticmethod
    def format_messages(
        user: str, system: Optional[str] = None, history: Optional[Sequence[Message]] = None
    ) -> List[Message]:
        out: List[Message] = []
        if system:
            out.append({"role": "system", "content": system})
        if history:
            out.extend(history)
        out.append({"role": "user", "content": user})
        return out

    # -- async twins -------------------------------------------------------

    async def achat(self, messages: Sequence[Message], **kwargs: Any) -> str:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._pool(), lambda: self.chat(messages, **kwargs)
        )

    async def aparse_chat(
        self, messages: Sequence[Message], response_format: Type[T], **kwargs: Any
    ) -> T:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._pool(), lambda: self.parse_chat(messages, response_format, **kwargs)
        )

    async def astream_chat(self, messages: Sequence[Message], **kwargs: Any):
        # truly incremental: pump the sync generator from the executor
        # into a queue as pieces arrive — buffering the full stream first
        # made time-to-first-token equal total generation time
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()
        end = object()
        # consumer-gone flag: the finally below cannot `await` (closing an
        # async generator raises GeneratorExit at the yield, and awaiting
        # there is a RuntimeError) — so early termination signals the pump
        # to stop at the next piece instead of draining the whole stream
        stop = threading.Event()

        def notify(item) -> None:
            try:
                loop.call_soon_threadsafe(queue.put_nowait, item)
            except RuntimeError:
                pass  # event loop already closed; consumer is gone

        def pump() -> None:
            try:
                for piece in self.stream_chat(messages, **kwargs):
                    if stop.is_set():
                        return
                    notify(piece)
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                notify(exc)
                return
            notify(end)

        self._pool().submit(pump)
        try:
            while True:
                item = await queue.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    async def aembed(self, texts: Sequence[str], **kwargs: Any) -> List[List[float]]:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._pool(), lambda: self.embed(texts, **kwargs)
        )

    @classmethod
    def _pool(cls) -> ThreadPoolExecutor:
        if LLMBase._executor is None:
            LLMBase._executor = ThreadPoolExecutor(
                max_workers=16, thread_name_prefix="llm"
            )
        return LLMBase._executor

    # -- introspection -----------------------------------------------------

    def get_model_info(self) -> Dict[str, Any]:
        info: Dict[str, Any] = {
            "provider": type(self).__name__,
            "model": self.model,
            "temperature": self.temperature,
            "max_tokens": self.max_tokens,
        }
        if self.track_usage:
            info["usage"] = self.usage.as_dict()
        return info
