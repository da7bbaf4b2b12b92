"""Typed component configs for registry-driven app assembly (counterpart
of ``rag_arc_tpu/serving/configs.py``).

One JSON document describes an entire RAG pipeline (embedder, indexes,
retrievers, fusion, reranker, rewriter, LLM), validates into a
discriminated-union tree, and ``build()``s into a running ``RagPipeline``.

Port decisions:
- ``PipelineConfig.device`` (default ``"cuda"``) is passed down through
  ``build(device=...)`` to every component that allocates; the entry
  point runs on the card unless the document asks for ``"cpu"``.
- ``TORCH_EMBEDDINGS`` (``TorchEncoderEmbeddings``, the fields of the JAX
  package's ``FLAX_EMBEDDINGS``) replaces ``FLAX_EMBEDDINGS``: the port
  cannot re-derive Flax's seeded weights without JAX, so a document that
  names ``FLAX_EMBEDDINGS`` fails validation rather than silently serving
  other vectors.
- The graph configs build as the JAX package's do, the store on the
  ``device`` passed down; the BM25 mesh backend raises
  ``NotImplementedError`` naming the ROADMAP item that ports it ([#15]).
"""

from __future__ import annotations

from typing import Annotated, Any, List, Literal, Optional, Union

from pydantic import Field

from rag_arc_tpu_torch.framework.config import AbstractConfig


def _torch_dtype(name: Optional[str]):
    if name is None:
        return None
    import torch

    return {
        "float32": torch.float32,
        "bfloat16": torch.bfloat16,
        "int8": torch.int8,
    }[name]


# -- embeddings -------------------------------------------------------------


class HashEmbeddingsConfig(AbstractConfig):
    type: Literal["HASH_EMBEDDINGS"] = "HASH_EMBEDDINGS"
    dim: int = 64

    def target(self):
        from rag_arc_tpu_torch.models.embeddings import HashEmbeddings

        return HashEmbeddings

    def build(self, **_: Any):
        return self.target()(dim=self.dim)


class TorchEmbeddingsConfig(AbstractConfig):
    type: Literal["TORCH_EMBEDDINGS"] = "TORCH_EMBEDDINGS"
    dim: int = 768
    depth: int = 12
    heads: int = 12
    vocab_size: int = 32768
    max_len: int = 512
    batch_size: int = 64
    seed: int = 0
    # short texts pack several-to-a-row (block-diagonal attention)
    pack_short: bool = True

    def build(self, device: str = "cuda", **_: Any):
        from rag_arc_tpu_torch.models.encoder import TransformerConfig
        from rag_arc_tpu_torch.models.torch_embeddings import TorchEncoderEmbeddings

        cfg = TransformerConfig(
            vocab_size=self.vocab_size,
            dim=self.dim,
            depth=self.depth,
            heads=self.heads,
            max_len=self.max_len,
        )
        return TorchEncoderEmbeddings(
            cfg=cfg,
            batch_size=self.batch_size,
            seed=self.seed,
            pack_short=self.pack_short,
            device=device,
        )


EmbeddingsUnion = Annotated[
    Union[HashEmbeddingsConfig, TorchEmbeddingsConfig], Field(discriminator="type")
]


# -- llm ---------------------------------------------------------------------


class FakeLLMConfig(AbstractConfig):
    type: Literal["FAKE_LLM"] = "FAKE_LLM"

    def build(self, **_: Any):
        from rag_arc_tpu_torch.llm.fake import FakeLLM

        return FakeLLM()


class OpenAILLMConfig(AbstractConfig):
    type: Literal["OPENAI_LLM"] = "OPENAI_LLM"
    model: str
    base_url: str = "http://localhost:8000/v1"
    api_key: str = "EMPTY"
    temperature: float = 0.0
    max_tokens: Optional[int] = None
    track_usage: bool = False

    def build(self, **_: Any):
        from rag_arc_tpu_torch.llm.openai_compat import OpenAICompatLLM

        return OpenAICompatLLM(
            model=self.model,
            base_url=self.base_url,
            api_key=self.api_key,
            temperature=self.temperature,
            max_tokens=self.max_tokens,
            track_usage=self.track_usage,
        )


LLMUnion = Annotated[Union[FakeLLMConfig, OpenAILLMConfig], Field(discriminator="type")]


# -- retrieval ----------------------------------------------------------------


class DenseRetrieverConfig(AbstractConfig):
    type: Literal["DENSE"] = "DENSE"
    embeddings: EmbeddingsUnion
    metric: str = "cosine"
    index_type: str = "flat"
    nlist: int = 100
    nprobe: int = 8
    capacity: int = 4096
    search_type: str = "similarity"
    k: int = 10
    store_path: Optional[str] = None  # restore a saved index
    docstore_path: Optional[str] = None  # disk-backed docstore
    dtype: Optional[str] = None  # float32 | bfloat16 | int8
    hnsw_pq_m: int = 0
    # int8 residual rescore sidecar: default (int4) | int8 | none
    refine: Optional[str] = "default"

    def build(self, device: str = "cuda", **_: Any):
        from rag_arc_tpu_torch.index.vector_store import TorchVectorStore

        embedding = self.embeddings.build(device=device)
        dtype = _torch_dtype(self.dtype)
        if self.store_path:
            from rag_arc_tpu_torch.index.persistence import load_store

            store = load_store(self.store_path, embedding, dtype=dtype, device=device)
        else:
            store = TorchVectorStore(
                embedding=embedding,
                metric=self.metric,
                capacity=self.capacity,
                docstore_path=self.docstore_path,
                dtype=dtype,
                refine=(None if self.refine in (None, "none") else self.refine),
                device=device,
                index_type=self.index_type,
                nlist=self.nlist,
                nprobe=self.nprobe,
                hnsw_pq_m=self.hnsw_pq_m,
            )
        return store.as_retriever(
            search_type=self.search_type, search_kwargs={"k": self.k}
        )


class BM25RetrieverConfig(AbstractConfig):
    type: Literal["BM25"] = "BM25"
    k: int = 10
    k1: float = 1.5
    b: float = 0.75
    epsilon: float = 0.25
    backend: str = "auto"  # auto | host (C++ CSR) | hybrid (head-dense /
    # tail-sparse device, one card) | device (the mesh kernel)
    snapshot_path: Optional[str] = None

    def build(self, device: str = "cuda", **_: Any):
        from rag_arc_tpu_torch.retrieval.bm25 import BM25Retriever

        if self.backend == "device":
            raise NotImplementedError(
                "BM25RetrieverConfig(backend='device'), the mesh kernel, is not "
                "ported yet (ROADMAP Queue 1 [#15])"
            )
        if self.snapshot_path:
            return BM25Retriever.load_from_disk(self.snapshot_path, device=device)
        return BM25Retriever(
            k=self.k, k1=self.k1, b=self.b, epsilon=self.epsilon,
            backend=self.backend, device=device,
        )


RetrieverUnion = Annotated[
    Union[DenseRetrieverConfig, BM25RetrieverConfig], Field(discriminator="type")
]


class MultiPathConfig(AbstractConfig):
    type: Literal["MULTIPATH"] = "MULTIPATH"
    retrievers: List[RetrieverUnion]
    top_k: int = 10
    top_k_per_retriever: int = 50
    rrf_k: int = 60

    def build(self, device: str = "cuda", **_: Any):
        from rag_arc_tpu_torch.retrieval.multipath import MultiPathRetriever
        from rag_arc_tpu_torch.utils.fusion import RRFusion

        return MultiPathRetriever(
            [r.build(device=device) for r in self.retrievers],
            fusion_method=RRFusion(k=self.rrf_k),
            top_k=self.top_k,
            top_k_per_retriever=self.top_k_per_retriever,
        )


AnyRetrieverUnion = Annotated[
    Union[DenseRetrieverConfig, BM25RetrieverConfig, MultiPathConfig],
    Field(discriminator="type"),
]


# -- rerank / rewrite ------------------------------------------------------------


class CrossEncoderRerankConfig(AbstractConfig):
    type: Literal["CROSS_ENCODER"] = "CROSS_ENCODER"
    dim: int = 768
    depth: int = 12
    heads: int = 12
    vocab_size: int = 32768
    max_length: int = 512
    instruction: Optional[str] = None

    def build(self, device: str = "cuda", **_: Any):
        from rag_arc_tpu_torch.models.encoder import TransformerConfig
        from rag_arc_tpu_torch.rerank.cross_encoder import (
            DEFAULT_INSTRUCTION,
            CrossEncoderReranker,
        )

        cfg = TransformerConfig(
            vocab_size=self.vocab_size,
            dim=self.dim,
            depth=self.depth,
            heads=self.heads,
            max_len=self.max_length,
            causal=True,
        )
        return CrossEncoderReranker(
            cfg=cfg,
            instruction=self.instruction or DEFAULT_INSTRUCTION,
            max_length=self.max_length,
            device=device,
        )


class RewriteConfig(AbstractConfig):
    type: Literal["REWRITE"] = "REWRITE"
    llm: LLMUnion
    n_variants: int = 3

    def build(self, **_: Any):
        from rag_arc_tpu_torch.retrieval.rewrite import MultiQueryRewriter

        return MultiQueryRewriter(self.llm.build(), n_variants=self.n_variants)


# -- graphrag ----------------------------------------------------------------------


class GraphExtractorConfig(AbstractConfig):
    type: Literal["HYPERRAG_EXTRACTOR"] = "HYPERRAG_EXTRACTOR"
    llm: LLMUnion
    max_rounds: int = 3
    max_concurrent: int = 100
    clean: bool = True
    event_types: Optional[List[str]] = None
    entity_types: Optional[List[str]] = None

    def build(self, **_: Any):
        from rag_arc_tpu_torch.graph.hyperrag import HyperRAGGraphExtractor
        from rag_arc_tpu_torch.graph.prompts import ExtractionPromptConfig

        prompt = None
        if self.event_types or self.entity_types:
            kwargs = {}
            if self.event_types:
                kwargs["event_types"] = self.event_types
            if self.entity_types:
                kwargs["entity_types"] = self.entity_types
            prompt = ExtractionPromptConfig(**kwargs)
        return HyperRAGGraphExtractor(
            self.llm.build(),
            prompt=prompt,
            max_rounds=self.max_rounds,
            max_concurrent=self.max_concurrent,
            clean=self.clean,
        )


class GraphStoreConfig(AbstractConfig):
    type: Literal["ARRAY_GRAPH_STORE"] = "ARRAY_GRAPH_STORE"
    embeddings: EmbeddingsUnion
    merge_threshold: float = 0.95
    knn_top_k: int = 10
    knn_cutoff: float = 0.85
    snapshot_path: Optional[str] = None

    def build(self, device: str = "cuda", **_: Any):
        from rag_arc_tpu_torch.graph.store import ArrayGraphStore

        store = ArrayGraphStore(
            self.embeddings.build(device=device),
            merge_threshold=self.merge_threshold,
            knn_top_k=self.knn_top_k,
            knn_cutoff=self.knn_cutoff,
            device=device,
        )
        if self.snapshot_path:
            store.load(self.snapshot_path)
        return store


# -- pipeline ----------------------------------------------------------------------


class PipelineConfig(AbstractConfig):
    type: Literal["PIPELINE"] = "PIPELINE"
    retriever: AnyRetrieverUnion
    reranker: Optional[CrossEncoderRerankConfig] = None
    rewrite: Optional[RewriteConfig] = None
    top_k: int = 10
    recall_k: int = 100  # candidates fetched before rerank
    batch_max: int = 128
    batch_wait_ms: float = 3.0
    device: str = "cuda"  # every component's device; "cpu" only when asked

    def build(self, **_: Any):
        from rag_arc_tpu_torch.serving.pipeline import RagPipeline

        return RagPipeline(
            retriever=self.retriever.build(device=self.device),
            reranker=self.reranker.build(device=self.device) if self.reranker else None,
            rewriter=self.rewrite.build() if self.rewrite else None,
            top_k=self.top_k,
            recall_k=self.recall_k,
            batch_max=self.batch_max,
            batch_wait_ms=self.batch_wait_ms,
        )
