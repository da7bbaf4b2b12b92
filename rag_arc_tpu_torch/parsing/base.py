"""Parser interface.

The port's own copy of ``rag_arc_tpu/parsing/base.py``, its behaviour
unchanged, so the port imports nothing of the JAX package.

The reference's parsers (``core/file_management/parser/`` — SURVEY.md §2.8)
each write sidecar files and return markdown. Here parsers return a
``ParsedDocument`` (markdown + extracted assets + structure) and leave IO
to the caller; ``save()`` reproduces the reference's file outputs when
wanted. All OOXML parsers are dependency-free (stdlib ``zipfile`` +
``xml.etree``) because python-docx/openpyxl/python-pptx are not in this
image — and OOXML is just zipped XML.
"""

from __future__ import annotations

import hashlib
import html
import json
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from rag_arc_tpu_torch.utils.data_model import Document


@dataclass
class ParsedDocument:
    markdown: str
    source: str
    assets: Dict[str, bytes] = field(default_factory=dict)  # rel path → bytes
    metadata: Dict[str, object] = field(default_factory=dict)

    def to_document(self) -> Document:
        return Document(
            content=self.markdown, metadata={"source": self.source, **self.metadata}
        )

    def save(self, out_dir: str | Path) -> Path:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        stem = Path(self.source).stem or "document"
        # stem ownership manifest: re-saving the SAME source overwrites
        # (idempotent re-ingest); a DIFFERENT source sharing the stem
        # (a/index.html + b/index.html) gets a source-hash suffix instead
        # of silently clobbering — existence of the md alone can't tell
        # those two cases apart
        manifest_path = out_dir / ".sources.json"
        try:
            manifest = json.loads(manifest_path.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            manifest = {}
        owner = manifest.get(stem)
        if owner is not None and owner != str(self.source):
            suffix = hashlib.md5(str(self.source).encode()).hexdigest()[:8]
            stem = f"{stem}-{suffix}"
        manifest[stem] = str(self.source)
        manifest_path.write_text(
            json.dumps(manifest, sort_keys=True, ensure_ascii=False),
            encoding="utf-8",
        )
        md_path = out_dir / f"{stem}.md"
        # assets are namespaced per document: every source emits the same
        # page_N_picture_M.png names, so flat placement clobbers across
        # sources; the in-memory markdown links bare names — rewrite them
        # to the namespaced location as part of the save
        markdown = self.markdown
        for rel in self.assets:
            markdown = markdown.replace(f"]({rel})", f"]({stem}/{rel})")
        md_path.write_text(markdown, encoding="utf-8")
        for rel, blob in self.assets.items():
            asset_path = out_dir / stem / rel
            asset_path.parent.mkdir(parents=True, exist_ok=True)
            asset_path.write_bytes(blob)
        return md_path


class ParserBase(ABC):
    """File → ParsedDocument."""

    extensions: tuple[str, ...] = ()

    @abstractmethod
    def parse(self, path: str | Path) -> ParsedDocument: ...

    def can_parse(self, path: str | Path) -> bool:
        return Path(path).suffix.lower().lstrip(".") in self.extensions


def rows_to_html_table(rows: List[List[str]], header: Optional[List[str]] = None) -> str:
    """Render rows as an HTML table (the reference emits tables as HTML
    inside markdown across all parsers)."""
    parts = ["<table>"]
    if header is not None:
        parts.append(
            "<tr>" + "".join(f"<th>{html.escape(str(c))}</th>" for c in header) + "</tr>"
        )
    for row in rows:
        parts.append(
            "<tr>" + "".join(f"<td>{html.escape(str(c))}</td>" for c in row) + "</tr>"
        )
    parts.append("</table>")
    return "\n".join(parts)
