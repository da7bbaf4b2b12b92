"""rag_arc_tpu_torch — the PyTorch/CUDA port of rag_arc_tpu.

A second package beside ``rag_arc_tpu``: the same layout and names, in
PyTorch, with each TPU kernel on the ported path rewritten by hand for
Hopper (``csrc/``). The JAX package is the reference the port is tested
against; the port itself imports neither JAX nor anything of the JAX
package: it keeps its own copies of the host-only modules it needs (data
model, tokenizer, packing, the embeddings interface, locks, tracing,
rank fusion, the native loader and its C++ sources).

Ported so far — the dense main path, the int8 index, the reranker, the
kernel probe, sparse and hybrid retrieval (BM25, RRF, multi-path), MMR,
and serving and ingest:

  models/     TextEncoder / PackedTextEncoder, CausalLM,
              TorchEncoderEmbeddings, Qwen3LM / Qwen3Embeddings, the Flax
              and HF → torch weight bridges
  ops/        scoring, masked top-k, the sub-tile-max kernel wrappers and
              the producer switch (stream, stream_piped, scan), the
              two-level select + rescore, rope_prep, flash attention, the
              fused MIPS top-k, the corpus-stream floor, the BM25 device
              programs (doc-major scan, hybrid head matmul + tail slabs,
              tail-only sort/segment-sum), RRF over positions, MMR (host)
  index/      DeviceFlatIndex (f32/bf16/int8), Docstore, BlobDocstore,
              TorchVectorStore (multi_query_search and MMR included),
              snapshots, DeviceBM25Index (host / device / hybrid backends,
              the per-query router and the device-query coalescer)
  retrieval/  BaseRetriever, VectorStoreRetriever, BM25Retriever,
              MultiPathRetriever, MultiQueryRewriter / RewriteRetriever
  rerank/     RerankerBase, CrossEncoderReranker
  serving/    QueryBatcher, RagPipeline, the HTTP app (python -m
              rag_arc_tpu_torch.serving.app --store DIR | --config JSON),
              the PipelineConfig tree
  framework/  tagged-union pydantic configs and the Register singleton
  llm/        LLMBase, FakeLLM, OpenAICompatLLM (stdlib HTTP)
  chunking/   the markdown, token, recursive and semantic splitters
  parsing/    txt/md, docx, xlsx/csv, pptx and html parsers, MultiParser
  native/     the host C++ BM25 scorer and tokenizer, built with g++ on
              first use
  tools/      ingest (python -m rag_arc_tpu_torch.tools.ingest DIR -o OUT),
              kernel_probe, bm25_synth (zipf CSR corpora and query
              profiles), doc_synth (multi-format document directories)
  utils/      Document, RWLock, stage tracing, TransferPool, rank fusion

Every allocating constructor takes an explicit ``device``.
"""

__version__ = "0.1.0"
