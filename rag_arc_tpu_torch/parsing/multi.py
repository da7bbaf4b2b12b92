"""Multi-format parser dispatch + CLI.

The port's own copy of ``rag_arc_tpu/parsing/multi.py``, its behaviour
unchanged but for the OCR path below, so the port imports nothing of the
JAX package.

Parity with the reference's ``multi_parser.py``: route a file, directory,
or URL to the right parser by extension; CLI writes markdown (and assets)
next to an output directory. The OCR path (PDFs and images through a VLM
endpoint, ``--vlm-url``) is not ported yet: asking for it raises
(ROADMAP Queue 1 #16).
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import Dict, List, Optional

from rag_arc_tpu_torch.parsing.base import ParsedDocument, ParserBase
from rag_arc_tpu_torch.parsing.docx_parser import DocxParser
from rag_arc_tpu_torch.parsing.html_parser import HtmlParser
from rag_arc_tpu_torch.parsing.pptx_parser import PptxParser
from rag_arc_tpu_torch.parsing.text_parser import TextParser
from rag_arc_tpu_torch.parsing.xlsx_parser import ExcelParser

logger = logging.getLogger(__name__)


class MultiParser:
    def __init__(self, vlm_url: Optional[str] = None, vlm_model: str = "layout-vlm"):
        self.parsers: List[ParserBase] = [
            DocxParser(),
            ExcelParser(),
            PptxParser(),
            HtmlParser(),
            TextParser(),
        ]
        if vlm_url:
            raise NotImplementedError(
                "the VLM OCR parser family is not ported yet (ROADMAP Queue 1 [#16])"
            )

    def parser_for(self, path: str | Path) -> Optional[ParserBase]:
        if str(path).startswith(("http://", "https://")):
            return next(p for p in self.parsers if isinstance(p, HtmlParser))
        for parser in self.parsers:
            if parser.can_parse(path):
                return parser
        return None

    def parse(self, path: str | Path) -> ParsedDocument:
        parser = self.parser_for(path)
        if parser is None:
            raise ValueError(
                f"no parser for {path} (supported: "
                f"{sorted(e for p in self.parsers for e in p.extensions)})"
            )
        return parser.parse(path)

    def parse_tree(self, root: str | Path) -> Dict[str, ParsedDocument]:
        """Parse every supported file under a directory."""
        out: Dict[str, ParsedDocument] = {}
        for path in sorted(Path(root).rglob("*")):
            if not path.is_file() or self.parser_for(path) is None:
                continue
            try:
                out[str(path)] = self.parse(path)
            except Exception as exc:  # noqa: BLE001 — per-file isolation
                logger.warning("failed to parse %s: %s", path, exc)
        return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="parse documents to markdown")
    ap.add_argument("input", help="file, directory, or URL")
    ap.add_argument("-o", "--output", default="parsed_out", help="output directory")
    ap.add_argument("--vlm-url", default=None, help="OpenAI-compatible VLM endpoint for PDF/image OCR")
    ap.add_argument("--vlm-model", default="layout-vlm")
    args = ap.parse_args(argv)

    mp = MultiParser(vlm_url=args.vlm_url, vlm_model=args.vlm_model)
    target = Path(args.input)
    if target.is_dir():
        results = mp.parse_tree(target)
    else:
        results = {args.input: mp.parse(args.input)}
    for src, doc in results.items():
        out = doc.save(args.output)
        print(f"{src} -> {out}")
    return 0 if results else 1


if __name__ == "__main__":
    sys.exit(main())
