"""End-to-end corpus ingestion (counterpart of ``rag_arc_tpu/tools/ingest.py``).

Parse files (docx/xlsx/pptx/html/markdown/text) → chunk → embed → build
the dense index (+ optional BM25 twin) → write snapshots that
``serving/app.py --store`` and the serving configs can point at
(``DenseRetrieverConfig.store_path``, ``BM25RetrieverConfig.snapshot_path``).
Snapshots are the JAX package's formats: either package serves the other's.

    python -m rag_arc_tpu_torch.tools.ingest docs/ -o snapshots/corpus \
        --chunker recursive --chunk-size 800 --embedder hash --bm25

``--embedder torch`` is the 768×12 ``TorchEncoderEmbeddings`` (the JAX
package's ``flax``); ``--device`` (default ``cuda``) places the index and
the encoder. IVF/HNSW indexes and the VLM OCR parsers are not ported yet
and raise.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path
from typing import List, Optional

from rag_arc_tpu_torch.chunking import (
    MarkdownHeaderTextSplitter,
    RecursiveCharacterTextSplitter,
    SemanticChunker,
    TokenTextSplitter,
)
from rag_arc_tpu_torch.index.persistence import save_store
from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
from rag_arc_tpu_torch.models.embeddings import Embeddings, HashEmbeddings
from rag_arc_tpu_torch.parsing.multi import MultiParser
from rag_arc_tpu_torch.utils.data_model import Document

logger = logging.getLogger(__name__)


def build_chunker(name: str, chunk_size: int, overlap: int, embeddings: Embeddings):
    if name == "recursive":
        return RecursiveCharacterTextSplitter(
            chunk_size=chunk_size, chunk_overlap=overlap
        )
    if name == "markdown":
        return MarkdownHeaderTextSplitter(max_chars=chunk_size, overlap=overlap)
    if name == "token":
        return TokenTextSplitter(
            tokens_per_chunk=max(chunk_size // 4, 16), chunk_overlap=overlap // 4
        )
    if name == "semantic":
        return SemanticChunker(embeddings)
    raise ValueError(f"unknown chunker {name!r}")


def build_embedder(name: str, dim: int, device: str = "cuda") -> Embeddings:
    if name == "hash":
        return HashEmbeddings(dim=dim)
    if name == "torch":
        from rag_arc_tpu_torch.models.encoder import TransformerConfig
        from rag_arc_tpu_torch.models.torch_embeddings import TorchEncoderEmbeddings

        return TorchEncoderEmbeddings(cfg=TransformerConfig(dim=dim), device=device)
    raise ValueError(f"unknown embedder {name!r} (hash | torch)")


class _TimedEmbeddings:
    """Forwards to an embedder and adds up the seconds its ``encode``
    takes: ingest's embed stage (the index stage is the rest of the adds)."""

    def __init__(self, inner: Embeddings):
        self.inner = inner
        self.seconds = 0.0

    def __getattr__(self, name: str):
        return getattr(self.inner, name)

    def encode(self, texts):
        t = time.perf_counter()
        try:
            return self.inner.encode(texts)
        finally:
            self.seconds += time.perf_counter() - t


def ingest(
    input_path: str | Path,
    output_dir: str | Path,
    chunker: str = "recursive",
    chunk_size: int = 800,
    overlap: int = 80,
    embedder: str = "hash",
    dim: int = 64,
    index_type: str = "flat",
    bm25: bool = False,
    vlm_url: Optional[str] = None,
    blob_docstore: bool = False,
    dtype: Optional[str] = None,
    metric: str = "cosine",
    batch: int = 256,
    *,
    device: str = "cuda",
) -> dict:
    """Ingest ``input_path`` into snapshots under ``output_dir``. Returns
    the JAX package's counts plus ``stages_s``: seconds spent parsing,
    chunking, embedding, adding to the index, saving and building BM25."""
    if index_type != "flat":
        raise NotImplementedError(
            f"index_type={index_type!r} is not ported yet (ROADMAP Queue 1 [#13])"
        )
    t0 = time.time()
    embeddings = _TimedEmbeddings(build_embedder(embedder, dim, device))
    splitter = build_chunker(chunker, chunk_size, overlap, embeddings.inner)
    parser = MultiParser(vlm_url=vlm_url)
    stages = {}

    input_path = Path(input_path)
    t = time.perf_counter()
    parsed = (
        parser.parse_tree(input_path)
        if input_path.is_dir()
        else {str(input_path): parser.parse(input_path)}
    )
    stages["parse"] = time.perf_counter() - t
    t = time.perf_counter()
    documents: List[Document] = []
    for src, doc in parsed.items():
        pieces = splitter.split_documents([doc.to_document()])
        for piece in pieces:
            piece.metadata["source"] = src
        documents.extend(pieces)
    stages["chunk"] = time.perf_counter() - t
    if not documents:
        raise ValueError(f"nothing ingestible under {input_path}")
    logger.info("parsed %d files -> %d chunks", len(parsed), len(documents))

    if dtype is not None:
        import torch

        dtype = {
            "float32": torch.float32,
            "bfloat16": torch.bfloat16,
            "int8": torch.int8,
        }[str(dtype)]
    output_dir = Path(output_dir)
    store = TorchVectorStore(
        embedding=embeddings,
        metric=metric,
        dtype=dtype,
        capacity=max(len(documents), 1024),
        # disk-backed content for big corpora: write the blob straight
        # into the snapshot so save_store is a no-op copy
        docstore_path=str(output_dir / "dense" / "docstore_blob")
        if blob_docstore
        else None,
        device=device,
    )
    t = time.perf_counter()
    # batched adds: bounds peak embed memory and gives progress on big runs
    for start in range(0, len(documents), batch):
        store.add_documents(documents[start : start + batch])
        done = min(start + batch, len(documents))
        if done == len(documents) or done % (batch * 8) == 0:
            logger.info("indexed %d/%d", done, len(documents))
    stages["embed"] = embeddings.seconds
    stages["index"] = time.perf_counter() - t - embeddings.seconds
    t = time.perf_counter()
    save_store(store, output_dir / "dense")
    stages["save"] = time.perf_counter() - t
    out = {
        "files": len(parsed),
        "chunks": len(documents),
        "dense_snapshot": str(output_dir / "dense"),
    }
    if bm25:
        from rag_arc_tpu_torch.retrieval.bm25 import BM25Retriever

        t = time.perf_counter()
        sparse = BM25Retriever.from_documents(documents, device=device)
        sparse.save_to_disk(output_dir / "bm25.json")
        stages["bm25"] = time.perf_counter() - t
        out["bm25_snapshot"] = str(output_dir / "bm25.json")
    out["elapsed_s"] = round(time.time() - t0, 2)
    out["stages_s"] = {name: round(s, 3) for name, s in stages.items()}
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="parse, chunk, embed, and index a corpus")
    ap.add_argument("input", help="file or directory")
    ap.add_argument("-o", "--output", "--out", required=True, help="snapshot directory")
    ap.add_argument(
        "--chunker",
        default="recursive",
        choices=["recursive", "markdown", "token", "semantic"],
    )
    ap.add_argument("--chunk-size", type=int, default=800)
    ap.add_argument("--overlap", "--chunk-overlap", type=int, default=80)
    ap.add_argument("--embedder", "--embeddings", default="hash",
                    choices=["hash", "torch"])
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--index-type", default="flat", choices=["flat", "ivf", "hnsw"])
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16", "int8"],
                    help="index storage dtype (default: the store's default)")
    ap.add_argument("--metric", default="cosine", choices=["cosine", "l2", "ip"])
    ap.add_argument("--batch", type=int, default=256, help="embed/add batch size")
    ap.add_argument("--bm25", action="store_true", help="also build a BM25 snapshot")
    ap.add_argument("--vlm-url", default=None, help="VLM endpoint for PDF/image OCR")
    ap.add_argument(
        "--blob-docstore",
        "--docstore-blob",
        action="store_true",
        help="keep document content on disk (mmap)",
    )
    ap.add_argument("--device", default="cuda", help="device of the index and encoder")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    stats = ingest(
        args.input,
        args.output,
        chunker=args.chunker,
        chunk_size=args.chunk_size,
        overlap=args.overlap,
        embedder=args.embedder,
        dim=args.dim,
        index_type=args.index_type,
        bm25=args.bm25,
        vlm_url=args.vlm_url,
        blob_docstore=args.blob_docstore,
        dtype=args.dtype,
        metric=args.metric,
        batch=args.batch,
        device=args.device,
    )
    for key, value in stats.items():
        print(f"{key}: {value}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
