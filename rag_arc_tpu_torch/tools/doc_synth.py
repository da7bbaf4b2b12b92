"""A directory of documents in every format the parsers read, made from a
seed, for driving ingest end to end.

    python -m rag_arc_tpu_torch.tools.doc_synth out_dir --files 4096

Each file holds a few paragraphs of random pseudo-words (a 20,000-word
vocabulary), so every chunk is distinctive. The OOXML formats are written
with ``zipfile`` in the minimal shape the parsers accept (the same shape
as the JAX package's parser tests build): ``.docx`` (a heading, body
paragraphs, one table), ``.xlsx`` (one sheet of inline strings, named
after the file) and ``.pptx`` (one slide of text boxes); ``.txt``, ``.md``
and ``.html`` are plain text.
"""

from __future__ import annotations

import argparse
import html
import zipfile
from pathlib import Path
from typing import Dict, List, Sequence
from xml.sax.saxutils import escape

import numpy as np

FORMATS = ("txt", "md", "html", "docx", "xlsx", "pptx")
VOCAB = 20_000

W_NS = 'xmlns:w="http://schemas.openxmlformats.org/wordprocessingml/2006/main"'
S_NS = 'xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"'
A_NS = "http://schemas.openxmlformats.org/drawingml/2006/main"
P_NS = "http://schemas.openxmlformats.org/presentationml/2006/main"


def _vocab(rng: np.random.Generator) -> np.ndarray:
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    lens = rng.integers(3, 10, VOCAB)
    chars = letters[rng.integers(0, 26, int(lens.sum()))]
    ends = np.cumsum(lens)
    return np.array(["".join(chars[e - n : e]) for n, e in zip(lens, ends)], dtype=object)


def _paragraphs(rng, vocab, n_par: int, words: Sequence[int]) -> List[str]:
    return [" ".join(vocab[rng.integers(0, VOCAB, int(rng.integers(*words)))])
            for _ in range(n_par)]


def _docx(title: str, pars: List[str]) -> Dict[str, str]:
    def p(text, style=None):
        ppr = f'<w:pPr><w:pStyle w:val="{style}"/></w:pPr>' if style else ""
        return f"<w:p>{ppr}<w:r><w:t>{escape(text)}</w:t></w:r></w:p>"

    cells = pars[-1].split()[:4] or ["x"]
    row = "".join(f"<w:tc>{p(c)}</w:tc>" for c in cells)
    body = p(title, "Heading1") + "".join(p(t) for t in pars[:-1])
    body += f"<w:tbl><w:tr>{row}</w:tr></w:tbl>"
    return {"word/document.xml":
            f'<?xml version="1.0"?><w:document {W_NS}><w:body>{body}</w:body></w:document>'}


def _xlsx(title: str, pars: List[str]) -> Dict[str, str]:
    rows = []
    for r, text in enumerate([title] + pars, start=1):
        # short rows: the table stays one chunk, where a split would leave
        # the same closing-tag chunk in many files
        words = text.split()[:8]
        cells = "".join(
            f'<c r="{chr(65 + c)}{r}" t="inlineStr"><is><t>{escape(" ".join(words[c::3]))}'
            f"</t></is></c>" for c in range(3))
        rows.append(f'<row r="{r}">{cells}</row>')
    sheet = (f'<?xml version="1.0"?><worksheet {S_NS}><sheetData>{"".join(rows)}'
             f"</sheetData></worksheet>")
    # the sheet is named after the file: the parser's "## <sheet>" header
    # can become a chunk of its own, and chunks must not repeat
    workbook = (f'<?xml version="1.0"?><workbook {S_NS} xmlns:r="http://schemas.'
                'openxmlformats.org/officeDocument/2006/relationships"><sheets>'
                f'<sheet name="{escape(title)}" sheetId="1" r:id="rId1"/></sheets></workbook>')
    rels = ('<?xml version="1.0"?><Relationships xmlns="http://schemas.openxmlformats.'
            'org/package/2006/relationships"><Relationship Id="rId1" '
            'Target="worksheets/sheet1.xml"/></Relationships>')
    return {"xl/workbook.xml": workbook, "xl/_rels/workbook.xml.rels": rels,
            "xl/worksheets/sheet1.xml": sheet}


def _pptx(title: str, pars: List[str]) -> Dict[str, str]:
    shapes = []
    for i, text in enumerate([title] + pars):
        shapes.append(
            f'<p:sp><p:spPr><a:xfrm><a:off x="100" y="{100 + 1000 * i}"/></a:xfrm></p:spPr>'
            f"<p:txBody><a:p><a:r><a:t>{escape(text)}</a:t></a:r></a:p></p:txBody></p:sp>")
    slide = (f'<?xml version="1.0"?><p:sld xmlns:p="{P_NS}" xmlns:a="{A_NS}"><p:cSld>'
             f'<p:spTree>{"".join(shapes)}</p:spTree></p:cSld></p:sld>')
    return {"ppt/slides/slide1.xml": slide}


def write_corpus(
    root: str | Path,
    n_files: int,
    seed: int = 0,
    formats: Sequence[str] = FORMATS,
    paragraphs: Sequence[int] = (2, 6),
    words: Sequence[int] = (20, 90),
) -> Dict[str, str]:
    """Write ``n_files`` documents under ``root``, the formats in turn;
    returns {path: format}. ``paragraphs`` and ``words`` are [low, high)
    ranges per file and per paragraph."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    vocab = _vocab(rng)
    out: Dict[str, str] = {}
    for i in range(n_files):
        fmt = formats[i % len(formats)]
        title = f"document {i} " + " ".join(vocab[rng.integers(0, VOCAB, 3)])
        pars = _paragraphs(rng, vocab, int(rng.integers(*paragraphs)), words)
        path = root / f"doc{i:06d}.{fmt}"
        if fmt == "txt":
            path.write_text(title + "\n\n" + "\n\n".join(pars) + "\n", encoding="utf-8")
        elif fmt == "md":
            body = "\n\n".join(f"## part {j}\n{t}" for j, t in enumerate(pars))
            path.write_text(f"# {title}\n\n{body}\n", encoding="utf-8")
        elif fmt == "html":
            body = "".join(f"<h2>part {j}</h2><p>{html.escape(t)}</p>" for j, t in enumerate(pars))
            path.write_text(f"<html><head><title>{html.escape(title)}</title></head><body>"
                            f"<nav>menu</nav><article>{body}</article></body></html>",
                            encoding="utf-8")
        elif fmt in ("docx", "xlsx", "pptx"):
            parts = {"docx": _docx, "xlsx": _xlsx, "pptx": _pptx}[fmt](title, pars)
            with zipfile.ZipFile(path, "w") as zf:
                for name, xml in parts.items():
                    zf.writestr(name, xml)
        else:
            raise ValueError(f"unknown format {fmt!r} (one of {FORMATS})")
        out[str(path)] = fmt
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="write a seeded multi-format corpus")
    ap.add_argument("out", help="directory to write")
    ap.add_argument("--files", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--formats", default=",".join(FORMATS),
                    help=f"comma-separated subset of {','.join(FORMATS)}")
    args = ap.parse_args(argv)
    written = write_corpus(args.out, args.files, args.seed, tuple(args.formats.split(",")))
    print(f"wrote {len(written)} files under {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
