"""HTML parser.

The port's own copy of ``rag_arc_tpu/parsing/html_parser.py``, its behaviour
unchanged but for when bs4 is imported, so the port imports nothing of
the JAX package.

Behavior parity with the reference's ``HtmlParser``
(``core/file_management/parser/html_parser.py``): accepts a file path, raw
HTML string, or URL; extracts the main content and title; converts to
markdown with ATX headings. The reference leans on readability-lxml +
markdownify (absent here) — main-content extraction is a boilerplate-
stripping heuristic over bs4, and the markdown converter is our own walk.
bs4 is imported when a page is parsed, not with the module: ingest and
the parser dispatch import this module on machines without bs4.
"""

from __future__ import annotations

import hashlib
import re
import urllib.request
from pathlib import Path

from rag_arc_tpu_torch.parsing.base import ParsedDocument, ParserBase

BOILERPLATE_TAGS = ("script", "style", "noscript", "nav", "footer", "aside", "form")

BLOCK_TAGS = {"p", "div", "section", "article", "li", "tr", "table", "blockquote"}


class HtmlParser(ParserBase):
    extensions = ("html", "htm")

    def parse(self, source: str | Path) -> ParsedDocument:
        from bs4 import BeautifulSoup

        src = str(source)
        if src.startswith(("http://", "https://")):
            with urllib.request.urlopen(src, timeout=30) as resp:
                html = resp.read().decode("utf-8", errors="replace")
            name = hashlib.md5(src.encode()).hexdigest()  # ref html_parser.py:42
        elif "<" in src and ">" in src and not Path(src[:200]).exists():
            html, name = src, "inline"
        else:
            html = Path(src).read_text(encoding="utf-8", errors="replace")
            name = Path(src).stem
        soup = BeautifulSoup(html, "lxml")
        title = soup.title.get_text(strip=True) if soup.title else ""
        main = self._main_content(soup)
        markdown = self._to_markdown(main).strip()
        if title:
            markdown = f"# {title}\n\n{markdown}"
        return ParsedDocument(
            markdown=markdown + "\n",
            source=src if len(src) < 200 else name,
            metadata={"parser": "html", "title": title},
        )

    # -- main-content extraction -------------------------------------------

    def _main_content(self, soup: BeautifulSoup) -> Tag:
        for tag in soup.find_all(BOILERPLATE_TAGS):
            tag.decompose()
        for candidate in ("main", "article"):
            found = soup.find(candidate)
            if found is not None and len(found.get_text(strip=True)) > 100:
                return found
        return soup.body or soup

    # -- markdown conversion ------------------------------------------------

    def _to_markdown(self, node) -> str:
        from bs4 import NavigableString, Tag

        if isinstance(node, NavigableString):
            return re.sub(r"\s+", " ", str(node))
        if not isinstance(node, Tag):
            return ""
        name = node.name.lower()
        inner = "".join(self._to_markdown(c) for c in node.children)
        if name in ("h1", "h2", "h3", "h4", "h5", "h6"):
            return f"\n{'#' * int(name[1])} {inner.strip()}\n\n"
        if name == "p":
            return f"\n{inner.strip()}\n\n"
        if name == "br":
            return "\n"
        if name == "hr":
            return "\n---\n"
        if name in ("strong", "b"):
            return f"**{inner.strip()}**" if inner.strip() else ""
        if name in ("em", "i"):
            return f"*{inner.strip()}*" if inner.strip() else ""
        if name == "code" and (node.parent is None or node.parent.name != "pre"):
            return f"`{inner.strip()}`"
        if name == "pre":
            return f"\n```\n{node.get_text()}\n```\n\n"
        if name == "a":
            href = node.get("href", "")
            text = inner.strip() or href
            return f"[{text}]({href})" if href else text
        if name == "img":
            return f"![{node.get('alt', '')}]({node.get('src', '')})"
        if name == "li":
            depth = len([p for p in node.parents if p.name in ("ul", "ol")]) - 1
            marker = "-"
            parent = node.parent
            if parent is not None and parent.name == "ol":
                marker = f"{sum(1 for s in node.find_previous_siblings('li')) + 1}."
            return f"{'  ' * max(depth, 0)}{marker} {inner.strip()}\n"
        if name in ("ul", "ol"):
            return f"\n{inner}\n"
        if name == "table":
            return self._table_to_markdown(node)
        if name == "blockquote":
            quoted = "\n".join(
                f"> {line}" for line in inner.strip().split("\n") if line.strip()
            )
            return f"\n{quoted}\n\n"
        if name in BLOCK_TAGS:
            return f"{inner}\n"
        return inner

    def _table_to_markdown(self, table: Tag) -> str:
        rows = []
        for tr in table.find_all("tr"):
            cells = [
                re.sub(r"\s+", " ", td.get_text(strip=True))
                for td in tr.find_all(["th", "td"])
            ]
            if cells:
                rows.append(cells)
        if not rows:
            return ""
        width = max(len(r) for r in rows)
        rows = [r + [""] * (width - len(r)) for r in rows]
        lines = ["| " + " | ".join(rows[0]) + " |", "|" + "---|" * width]
        for r in rows[1:]:
            lines.append("| " + " | ".join(r) + " |")
        return "\n" + "\n".join(lines) + "\n\n"
