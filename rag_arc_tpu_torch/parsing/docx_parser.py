"""DOCX parser (dependency-free OOXML).

The port's own copy of ``rag_arc_tpu/parsing/docx_parser.py``, its behaviour
unchanged, so the port imports nothing of the JAX package.

Behavior parity with the reference's ``DocxParser``
(``core/file_management/parser/docx_parser.py:43-121``): walk the document
body in order — paragraphs → text (heading styles → markdown headers),
tables → HTML, embedded images → extracted assets + markdown links, page
breaks → ``---``. The reference uses python-docx; this implementation reads
``word/document.xml`` directly (a .docx is a zip of XML), which also drops
the pandoc/OCR shell-out path in favor of the JAX package's OCR pipeline
(``rag_arc_tpu/parsing/ocr.py``; not ported yet, ROADMAP Queue 1 #16).
"""

from __future__ import annotations

import hashlib
import re
import zipfile
from pathlib import Path
from typing import Dict, List, Optional
from xml.etree import ElementTree as ET

from rag_arc_tpu_torch.parsing.base import ParsedDocument, ParserBase, rows_to_html_table

W = "{http://schemas.openxmlformats.org/wordprocessingml/2006/main}"
A = "{http://schemas.openxmlformats.org/drawingml/2006/main}"
R = "{http://schemas.openxmlformats.org/officeDocument/2006/relationships}"
REL = "{http://schemas.openxmlformats.org/package/2006/relationships}"

_HEADING_RE = re.compile(r"^[Hh]eading\s*([1-6])$|^[1-6]$")


class DocxParser(ParserBase):
    extensions = ("docx",)

    def parse(self, path: str | Path) -> ParsedDocument:
        path = Path(path)
        with zipfile.ZipFile(path) as zf:
            doc_xml = zf.read("word/document.xml")
            rels = self._read_rels(zf, "word/_rels/document.xml.rels")
            root = ET.fromstring(doc_xml)
            body = root.find(f"{W}body")
            lines: List[str] = []
            assets: Dict[str, bytes] = {}
            n_tables = 0
            for child in body:
                if child.tag == f"{W}p":
                    lines.extend(self._paragraph(child, zf, rels, assets))
                elif child.tag == f"{W}tbl":
                    lines.append(self._table(child))
                    lines.append("")
                    n_tables += 1
        markdown = "\n".join(lines).strip() + "\n"
        return ParsedDocument(
            markdown=markdown,
            source=str(path),
            assets=assets,
            metadata={"parser": "docx", "tables": n_tables, "images": len(assets)},
        )

    # -- pieces -----------------------------------------------------------

    @staticmethod
    def _read_rels(zf: zipfile.ZipFile, rel_path: str) -> Dict[str, str]:
        try:
            root = ET.fromstring(zf.read(rel_path))
        except KeyError:
            return {}
        return {
            rel.get("Id"): rel.get("Target")
            for rel in root.findall(f"{REL}Relationship")
        }

    def _paragraph(
        self,
        p: ET.Element,
        zf: zipfile.ZipFile,
        rels: Dict[str, str],
        assets: Dict[str, bytes],
    ) -> List[str]:
        out: List[str] = []
        style = p.find(f"{W}pPr/{W}pStyle")
        heading: Optional[int] = None
        if style is not None:
            m = _HEADING_RE.match(style.get(f"{W}val", ""))
            if m:
                heading = int(m.group(1) or m.group(0))
        texts: List[str] = []
        page_break = False
        for run in p.iter():
            if run.tag == f"{W}t":
                texts.append(run.text or "")
            elif run.tag == f"{W}br" and run.get(f"{W}type") == "page":
                page_break = True
            elif run.tag == f"{A}blip":
                rid = run.get(f"{R}embed")
                target = rels.get(rid)
                if target:
                    member = "word/" + target.lstrip("/")
                    try:
                        blob = zf.read(member)
                    except KeyError:
                        continue
                    ext = Path(target).suffix or ".png"
                    name = f"images/{hashlib.sha1(blob).hexdigest()[:16]}{ext}"
                    assets[name] = blob
                    texts.append(f"![image]({name})")
        text = "".join(texts).strip()
        if text:
            out.append(("#" * heading + " " + text) if heading else text)
            out.append("")
        if page_break:
            out.extend(["---", ""])
        return out

    def _table(self, tbl: ET.Element) -> str:
        rows: List[List[str]] = []
        for tr in tbl.findall(f"{W}tr"):
            row = []
            for tc in tr.findall(f"{W}tc"):
                cell_text = " ".join(
                    t.text or "" for t in tc.iter(f"{W}t")
                ).strip()
                row.append(cell_text)
            rows.append(row)
        if not rows:
            return ""
        return rows_to_html_table(rows[1:], header=rows[0])
