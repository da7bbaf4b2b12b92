"""Plain text / markdown passthrough parser.

The port's own copy of ``rag_arc_tpu/parsing/text_parser.py``, its behaviour
unchanged, so the port imports nothing of the JAX package.

Not in the reference (its multi-parser only routed pdf/docx/xlsx/pptx/
html), but without it an ingestion pipeline can't index .txt/.md corpora —
the most common case. Reads with encoding probing and passes content
through unchanged (markdown structure is the chunker's concern).
"""

from __future__ import annotations

from pathlib import Path

from rag_arc_tpu_torch.parsing.base import ParsedDocument, ParserBase

ENCODINGS = ("utf-8-sig", "utf-8", "gb18030", "latin-1")


class TextParser(ParserBase):
    extensions = ("txt", "md", "markdown", "rst", "log")

    def parse(self, path: str | Path) -> ParsedDocument:
        raw = Path(path).read_bytes()
        text = None
        for enc in ENCODINGS:
            try:
                text = raw.decode(enc)
                break
            except UnicodeDecodeError:
                continue
        if text is None:
            text = raw.decode("utf-8", errors="replace")
        return ParsedDocument(
            markdown=text,
            source=str(path),
            metadata={"parser": "text", "bytes": len(raw)},
        )
