"""Plain tokenization and the rerank prompt, written from the served
system's stated behaviour so the reference shares no code with it.

- Tokens: ``\\w+`` runs and single non-space symbols of the lower-cased
  text, each hashed to ``4 + md5(token)[:8] (little endian) mod (V - 4)``;
  a sequence is BOS (1), the tokens, EOS (2). Documents keep their head
  under truncation; the rerank prompt keeps its tail (its answer cue).
- The cross-encoder's judge prompt, with the default instruction.
"""

from __future__ import annotations

import hashlib
import re
from typing import List

BOS, EOS, N_SPECIAL = 1, 2, 4
_TOKEN_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)

INSTRUCTION = "Given a web search query, retrieve relevant passages that answer the query"
PROMPT = (
    "Judge whether the Document meets the requirements based on the Query "
    "and the Instruct provided. Answer only \"yes\" or \"no\".\n"
    "<Instruct>: {instruction}\n<Query>: {query}\n<Document>: {document}\n"
    "Answer:"
)


def token_id(token: str, vocab: int) -> int:
    h = int.from_bytes(hashlib.md5(token.encode("utf-8")).digest()[:8], "little")
    return N_SPECIAL + h % (vocab - N_SPECIAL)


def tokens(text: str, vocab: int, max_len: int, keep: str = "head") -> List[int]:
    body = [token_id(t, vocab) for t in _TOKEN_RE.findall(text.replace("\n", " ").lower())]
    body = body[: max_len - 2] if keep == "head" else body[-(max_len - 2):]
    return [BOS] + body + [EOS]


def rerank_prompt(query: str, document: str) -> str:
    return PROMPT.format(instruction=INSTRUCTION, query=query, document=document)
