"""PPTX parser (dependency-free OOXML).

The port's own copy of ``rag_arc_tpu/parsing/pptx_parser.py``, its behaviour
unchanged, so the port imports nothing of the JAX package.

Behavior parity with the reference's ``PptParser``
(``core/file_management/parser/ppt_parser.py``): slides become ``## Slide N``
markdown sections; shapes are emitted in reading order sorted by
``(top // coarse, left)`` (``ppt_parser.py:92-95``); bullet paragraphs
indent by level (``:11-16``); tables → HTML; groups recurse; images are
extracted to assets named by content sha1 (``:59-70``). Reads slide XML
directly instead of python-pptx.
"""

from __future__ import annotations

import hashlib
import re
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple
from xml.etree import ElementTree as ET

from rag_arc_tpu_torch.parsing.base import ParsedDocument, ParserBase, rows_to_html_table

P = "{http://schemas.openxmlformats.org/presentationml/2006/main}"
A = "{http://schemas.openxmlformats.org/drawingml/2006/main}"
R = "{http://schemas.openxmlformats.org/officeDocument/2006/relationships}"
REL = "{http://schemas.openxmlformats.org/package/2006/relationships}"

# EMU → coarse rows: 914400 EMU/inch; band shapes into ~0.3in rows so
# side-by-side shapes read left→right (reference's top//10 on pt units)
COARSE_EMU = 274320


class PptxParser(ParserBase):
    extensions = ("pptx",)

    def parse(self, path: str | Path) -> ParsedDocument:
        path = Path(path)
        assets: Dict[str, bytes] = {}
        parts: List[str] = []
        with zipfile.ZipFile(path) as zf:
            slide_names = sorted(
                (n for n in zf.namelist() if re.fullmatch(r"ppt/slides/slide\d+\.xml", n)),
                key=lambda n: int(re.search(r"(\d+)", n).group(1)),
            )
            for i, name in enumerate(slide_names, start=1):
                rels = self._read_rels(
                    zf, f"ppt/slides/_rels/{Path(name).name}.rels"
                )
                root = ET.fromstring(zf.read(name))
                parts.append(f"## Slide {i}\n")
                tree = root.find(f"{P}cSld/{P}spTree")
                if tree is not None:
                    parts.extend(self._shapes(tree, zf, rels, assets))
                parts.append("")
        return ParsedDocument(
            markdown="\n".join(parts).strip() + "\n",
            source=str(path),
            assets=assets,
            metadata={"parser": "pptx", "slides": len(slide_names), "images": len(assets)},
        )

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

    # -- shape walk (reading order) ----------------------------------------

    def _shape_pos(self, shape: ET.Element) -> Tuple[int, int]:
        off = shape.find(f".//{A}xfrm/{A}off")
        if off is None:
            return (0, 0)
        x = int(off.get("x", "0"))
        y = int(off.get("y", "0"))
        return (y // COARSE_EMU, x)

    def _shapes(
        self,
        tree: ET.Element,
        zf: zipfile.ZipFile,
        rels: Dict[str, str],
        assets: Dict[str, bytes],
    ) -> List[str]:
        shapes = [
            child
            for child in tree
            if child.tag in (f"{P}sp", f"{P}graphicFrame", f"{P}pic", f"{P}grpSp")
        ]
        shapes.sort(key=self._shape_pos)
        out: List[str] = []
        for shape in shapes:
            if shape.tag == f"{P}sp":
                out.extend(self._text_shape(shape))
            elif shape.tag == f"{P}graphicFrame":
                table = shape.find(f".//{A}tbl")
                if table is not None:
                    out.append(self._table(table))
                    out.append("")
            elif shape.tag == f"{P}pic":
                link = self._picture(shape, zf, rels, assets)
                if link:
                    out.append(link)
                    out.append("")
            elif shape.tag == f"{P}grpSp":  # groups recurse
                out.extend(self._shapes(shape, zf, rels, assets))
        return out

    def _text_shape(self, sp: ET.Element) -> List[str]:
        out = []
        for para in sp.findall(f".//{A}p"):
            text = "".join(t.text or "" for t in para.iter(f"{A}t")).strip()
            if not text:
                continue
            ppr = para.find(f"{A}pPr")
            level = int(ppr.get("lvl", "0")) if ppr is not None else 0
            out.append(("  " * level) + "- " + text)
        if out:
            out.append("")
        return out

    def _table(self, tbl: ET.Element) -> str:
        rows: List[List[str]] = []
        for tr in tbl.findall(f"{A}tr"):
            rows.append(
                [
                    " ".join(t.text or "" for t in tc.iter(f"{A}t")).strip()
                    for tc in tr.findall(f"{A}tc")
                ]
            )
        if not rows:
            return ""
        return rows_to_html_table(rows[1:], header=rows[0])

    def _picture(
        self,
        pic: ET.Element,
        zf: zipfile.ZipFile,
        rels: Dict[str, str],
        assets: Dict[str, bytes],
    ) -> Optional[str]:
        blip = pic.find(f".//{A}blip")
        if blip is None:
            return None
        target = rels.get(blip.get(f"{R}embed"))
        if not target:
            return None
        member = ("ppt/" + target.replace("../", "")) if target.startswith("..") else target
        try:
            blob = zf.read(member)
        except KeyError:
            return None
        ext = Path(target).suffix or ".png"
        name = f"images/{hashlib.sha1(blob).hexdigest()[:16]}{ext}"
        assets[name] = blob
        return f"![image]({name})"
