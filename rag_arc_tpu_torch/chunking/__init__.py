from rag_arc_tpu_torch.chunking.splitters import (
    MarkdownHeaderTextSplitter,
    RecursiveCharacterTextSplitter,
    SemanticChunker,
    TokenTextSplitter,
)

__all__ = [
    "MarkdownHeaderTextSplitter",
    "TokenTextSplitter",
    "RecursiveCharacterTextSplitter",
    "SemanticChunker",
]
