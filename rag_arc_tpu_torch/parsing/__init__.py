from rag_arc_tpu_torch.parsing.base import ParsedDocument, ParserBase
from rag_arc_tpu_torch.parsing.docx_parser import DocxParser
from rag_arc_tpu_torch.parsing.html_parser import HtmlParser
from rag_arc_tpu_torch.parsing.pptx_parser import PptxParser
from rag_arc_tpu_torch.parsing.xlsx_parser import ExcelParser

__all__ = [
    "ParserBase",
    "ParsedDocument",
    "DocxParser",
    "ExcelParser",
    "PptxParser",
    "HtmlParser",
]
