"""XLSX / CSV parser (dependency-free OOXML).

The port's own copy of ``rag_arc_tpu/parsing/xlsx_parser.py``, its behaviour
unchanged, so the port imports nothing of the JAX package.

Behavior parity with the reference's ``ExcelParser``
(``core/file_management/parser/excel_parser.py``): magic-byte sniffing
(``PK\\x03\\x04`` → xlsx, OLE2 → legacy xls, else CSV, ``excel_parser.py:39``),
CSV encoding detection, each sheet rendered as HTML ``<table>`` chunks of
256 rows with the header repeated per chunk (``:72-112``). The reference
uses openpyxl/pandas/chardet; here the xlsx zip (sharedStrings + sheet XML)
is read directly and encodings are probed from a candidate list.
"""

from __future__ import annotations

import csv
import io
import re
import zipfile
from pathlib import Path
from typing import Dict, List
from xml.etree import ElementTree as ET

from rag_arc_tpu_torch.parsing.base import ParsedDocument, ParserBase, rows_to_html_table

S = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
R = "{http://schemas.openxmlformats.org/officeDocument/2006/relationships}"
REL = "{http://schemas.openxmlformats.org/package/2006/relationships}"

XLSX_MAGIC = b"PK\x03\x04"
OLE2_MAGIC = b"\xd0\xcf\x11\xe0"

ROWS_PER_CHUNK = 256
ENCODING_CANDIDATES = ("utf-8-sig", "utf-8", "gb18030", "latin-1")

_CELL_REF_RE = re.compile(r"([A-Z]+)(\d+)")


def _col_index(ref: str) -> int:
    """A→0, B→1, ..., AA→26."""
    m = _CELL_REF_RE.match(ref)
    if not m:
        return 0
    col = 0
    for ch in m.group(1):
        col = col * 26 + (ord(ch) - ord("A") + 1)
    return col - 1


class ExcelParser(ParserBase):
    extensions = ("xlsx", "csv", "xls")

    def __init__(self, rows_per_chunk: int = ROWS_PER_CHUNK):
        self.rows_per_chunk = rows_per_chunk

    def parse(self, path: str | Path) -> ParsedDocument:
        path = Path(path)
        with path.open("rb") as f:  # 8 bytes, not the whole (maybe GB) file
            head = f.read(8)
        if head.startswith(XLSX_MAGIC):
            sheets = self._parse_xlsx(path)
        elif head.startswith(OLE2_MAGIC):
            raise ValueError(
                f"{path} is a legacy OLE2 .xls workbook; re-save as .xlsx or csv"
            )
        else:
            sheets = {"Sheet1": self._parse_csv(path)}
        parts: List[str] = []
        total_rows = 0
        for name, rows in sheets.items():
            if not rows:
                continue
            total_rows += len(rows)
            parts.append(f"## {name}\n")
            header, body = rows[0], rows[1:]
            for start in range(0, max(len(body), 1), self.rows_per_chunk):
                chunk = body[start : start + self.rows_per_chunk]
                parts.append(rows_to_html_table(chunk, header=header))
                parts.append("")
        return ParsedDocument(
            markdown="\n".join(parts).strip() + "\n",
            source=str(path),
            metadata={"parser": "excel", "sheets": len(sheets), "rows": total_rows},
        )

    # -- csv ---------------------------------------------------------------

    def _parse_csv(self, path: Path) -> List[List[str]]:
        raw = path.read_bytes()
        text = None
        for enc in ENCODING_CANDIDATES:
            try:
                text = raw.decode(enc)
                break
            except UnicodeDecodeError:
                continue
        if text is None:
            text = raw.decode("utf-8", errors="replace")
        sniff = csv.Sniffer()
        try:
            dialect = sniff.sniff(text[:4096], delimiters=",;\t|")
        except csv.Error:
            dialect = csv.excel
        return [row for row in csv.reader(io.StringIO(text), dialect)]

    # -- xlsx --------------------------------------------------------------

    def _parse_xlsx(self, path: Path) -> Dict[str, List[List[str]]]:
        with zipfile.ZipFile(path) as zf:
            shared = self._shared_strings(zf)
            wb = ET.fromstring(zf.read("xl/workbook.xml"))
            rels = {}
            try:
                rel_root = ET.fromstring(zf.read("xl/_rels/workbook.xml.rels"))
                rels = {
                    r.get("Id"): r.get("Target")
                    for r in rel_root.findall(f"{REL}Relationship")
                }
            except KeyError:
                pass
            sheets: Dict[str, List[List[str]]] = {}
            for i, sheet in enumerate(wb.findall(f"{S}sheets/{S}sheet")):
                name = sheet.get("name", f"Sheet{i + 1}")
                target = rels.get(sheet.get(f"{R}id"), f"worksheets/sheet{i + 1}.xml")
                # OPC allows absolute targets ('/xl/worksheets/sheet1.xml');
                # prefixing those again made 'xl/xl/...' and dropped the sheet
                member = (
                    target.lstrip("/")
                    if target.startswith("/")
                    else "xl/" + target
                )
                try:
                    sheet_xml = zf.read(member)
                except KeyError:
                    continue
                sheets[name] = self._sheet_rows(ET.fromstring(sheet_xml), shared)
        return sheets

    @staticmethod
    def _shared_strings(zf: zipfile.ZipFile) -> List[str]:
        try:
            root = ET.fromstring(zf.read("xl/sharedStrings.xml"))
        except KeyError:
            return []
        out = []
        for si in root.findall(f"{S}si"):
            out.append("".join(t.text or "" for t in si.iter(f"{S}t")))
        return out

    @staticmethod
    def _sheet_rows(root: ET.Element, shared: List[str]) -> List[List[str]]:
        rows: List[List[str]] = []
        for row in root.findall(f"{S}sheetData/{S}row"):
            cells: Dict[int, str] = {}
            next_col = 0  # ECMA-376: c/@r is optional; position is implied
            for c in row.findall(f"{S}c"):
                ref = c.get("r", "")
                col = _col_index(ref) if ref else next_col
                next_col = col + 1
                ctype = c.get("t", "n")
                if ctype == "inlineStr":
                    value = "".join(t.text or "" for t in c.iter(f"{S}t"))
                else:
                    v = c.find(f"{S}v")
                    value = v.text if v is not None and v.text else ""
                    if ctype == "s" and value != "":
                        try:
                            value = shared[int(value)]
                        except (ValueError, IndexError):
                            pass
                cells[col] = value
            width = max(cells) + 1 if cells else 0
            rows.append([cells.get(i, "") for i in range(width)])
        # normalize ragged rows to uniform width
        width = max((len(r) for r in rows), default=0)
        return [r + [""] * (width - len(r)) for r in rows]
