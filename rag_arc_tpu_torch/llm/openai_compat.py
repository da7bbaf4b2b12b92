"""OpenAI-protocol LLM client over stdlib HTTP.

The port's own copy of ``rag_arc_tpu/llm/openai_compat.py``, its behaviour
unchanged, so the port imports nothing of the JAX package.

Replaces the reference's ``OpenAILLM`` (``encapsulation/llm/openai_llm.py:5``)
without the ``openai`` package (not installed here): chat completions,
streaming (SSE), structured output via ``response_format`` JSON schema with
local pydantic validation, and embeddings batched at 100
(``openai_llm.py:139-165`` parity). Works against any OpenAI-compatible
``base_url`` — an actual OpenAI endpoint, a vLLM server, or the in-process
fake used in tests. Retries with exponential backoff (3 attempts, matching
``openai_llm.py:24-38``'s client config).
"""

from __future__ import annotations

import json
import logging
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Iterator, List, Optional, Sequence, Type, TypeVar

from pydantic import BaseModel

from rag_arc_tpu_torch.llm.base import LLMBase, Message

logger = logging.getLogger(__name__)

T = TypeVar("T", bound=BaseModel)


class OpenAICompatLLM(LLMBase):
    def __init__(
        self,
        model: str,
        base_url: str = "http://localhost:8000/v1",
        api_key: str = "EMPTY",
        temperature: float = 0.0,
        max_tokens: Optional[int] = None,
        timeout: float = 60.0,
        max_retries: int = 3,
        track_usage: bool = False,
    ):
        super().__init__(
            model=model,
            temperature=temperature,
            max_tokens=max_tokens,
            track_usage=track_usage,
        )
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.timeout = timeout
        self.max_retries = max_retries

    # -- transport ---------------------------------------------------------

    def _post(self, path: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        body = json.dumps(payload).encode("utf-8")
        last_err: Optional[Exception] = None
        for attempt in range(self.max_retries):
            try:
                req = urllib.request.Request(
                    f"{self.base_url}{path}",
                    data=body,
                    headers={
                        "Content-Type": "application/json",
                        "Authorization": f"Bearer {self.api_key}",
                    },
                    method="POST",
                )
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    return json.loads(resp.read().decode("utf-8"))
            except urllib.error.HTTPError as exc:
                # HTTPError subclasses URLError: without this branch a 400
                # was retried, then masked as 'unreachable' with the
                # server's error detail discarded. 4xx (minus 408/429) is
                # permanent — surface it immediately with the body.
                detail = ""
                try:
                    detail = exc.read().decode("utf-8", "replace")[:500]
                except Exception:  # noqa: BLE001 — detail is best-effort
                    pass
                if 400 <= exc.code < 500 and exc.code not in (408, 429):
                    raise RuntimeError(
                        f"LLM endpoint rejected the request "
                        f"(HTTP {exc.code}): {detail}"
                    ) from exc
                last_err = RuntimeError(f"HTTP {exc.code}: {detail}")
            except (urllib.error.URLError, TimeoutError, ConnectionError) as exc:
                last_err = exc
            if attempt + 1 < self.max_retries:
                wait = min(2.0**attempt, 8.0)
                logger.warning(
                    "LLM request failed (attempt %d/%d): %s; retrying in %.1fs",
                    attempt + 1,
                    self.max_retries,
                    last_err,
                    wait,
                )
                time.sleep(wait)  # no terminal sleep after the last attempt
        raise ConnectionError(
            f"LLM endpoint {self.base_url}{path} unreachable after "
            f"{self.max_retries} attempts"
        ) from last_err

    def _record_usage(self, data: Dict[str, Any]) -> None:
        # 'usage': null rides EVERY intermediate SSE chunk when
        # include_usage is set — counting those as requests inflated the
        # requests metric by the chunk count
        if self.track_usage and data.get("usage"):
            u = data["usage"]
            self.usage.add(
                int(u.get("prompt_tokens", 0)), int(u.get("completion_tokens", 0))
            )

    # -- chat --------------------------------------------------------------

    def chat(self, messages: Sequence[Message], **kwargs: Any) -> str:
        self.validate_input(messages)
        payload: Dict[str, Any] = {
            "model": self.model,
            "messages": list(messages),
            "temperature": kwargs.get("temperature", self.temperature),
        }
        max_tokens = kwargs.get("max_tokens", self.max_tokens)
        if max_tokens:
            payload["max_tokens"] = max_tokens
        data = self._post("/chat/completions", payload)
        self._record_usage(data)
        return data["choices"][0]["message"]["content"]

    def stream_chat(self, messages: Sequence[Message], **kwargs: Any) -> Iterator[str]:
        """SSE streaming; includes usage when tracking is enabled
        (stream_options.include_usage, openai_llm.py:55-60 parity)."""
        self.validate_input(messages)
        payload: Dict[str, Any] = {
            "model": self.model,
            "messages": list(messages),
            "temperature": kwargs.get("temperature", self.temperature),
            "stream": True,
        }
        if self.track_usage:
            payload["stream_options"] = {"include_usage": True}
        body = json.dumps(payload).encode("utf-8")
        req = urllib.request.Request(
            f"{self.base_url}/chat/completions",
            data=body,
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.api_key}",
            },
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            for raw in resp:
                line = raw.decode("utf-8").strip()
                if not line.startswith("data:"):
                    continue
                data_str = line[len("data:"):].strip()
                if data_str == "[DONE]":
                    break
                chunk = json.loads(data_str)
                self._record_usage(chunk)
                choices = chunk.get("choices") or []
                if choices:
                    delta = choices[0].get("delta", {})
                    piece = delta.get("content")
                    if piece:
                        yield piece

    # -- structured output -------------------------------------------------

    def parse_chat(
        self, messages: Sequence[Message], response_format: Type[T], **kwargs: Any
    ) -> T:
        self.validate_input(messages)
        schema = response_format.model_json_schema()
        payload: Dict[str, Any] = {
            "model": self.model,
            "messages": list(messages),
            "temperature": kwargs.get("temperature", self.temperature),
            "response_format": {
                "type": "json_schema",
                "json_schema": {
                    "name": response_format.__name__,
                    "schema": schema,
                    "strict": True,
                },
            },
        }
        # honor the completion cap here too — chat() already does, and an
        # uncapped structured extraction can run away on cost/latency
        max_tokens = kwargs.get("max_tokens", self.max_tokens)
        if max_tokens:
            payload["max_tokens"] = max_tokens
        data = self._post("/chat/completions", payload)
        self._record_usage(data)
        content = data["choices"][0]["message"]["content"]
        return response_format.model_validate_json(content)

    # -- embeddings --------------------------------------------------------

    EMBED_BATCH = 100

    def embed(self, texts: Sequence[str], **kwargs: Any) -> List[List[float]]:
        if not (self.model.startswith("text-embedding") or kwargs.get("force")):
            raise ValueError(
                f"model {self.model!r} is not an embedding model; "
                "use a text-embedding* model (or force=True for a custom server)"
            )
        out: List[List[float]] = []
        for start in range(0, len(texts), self.EMBED_BATCH):
            chunk = list(texts[start : start + self.EMBED_BATCH])
            data = self._post("/embeddings", {"model": self.model, "input": chunk})
            self._record_usage(data)
            rows = sorted(data["data"], key=lambda r: r["index"])
            out.extend([r["embedding"] for r in rows])
        return out

    def get_available_models(self) -> List[str]:
        req = urllib.request.Request(
            f"{self.base_url}/models",
            headers={"Authorization": f"Bearer {self.api_key}"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            data = json.loads(resp.read().decode("utf-8"))
        return [m["id"] for m in data.get("data", [])]
