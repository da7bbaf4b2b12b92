"""rag_arc_tpu_torch — the PyTorch/CUDA port of rag_arc_tpu.

A second package beside ``rag_arc_tpu``: the same layout and names, in
PyTorch, with each TPU kernel on the ported path rewritten by hand for
Hopper (``csrc/``). The JAX package is the reference the port is tested
against; the port itself never imports JAX. It reuses the JAX package's
host-only modules (data model, tokenizer, packing, locks, tracing).

Ported so far — the dense main path, the int8 index and the reranker:

  models/     TextEncoder / PackedTextEncoder, CausalLM,
              TorchEncoderEmbeddings, Qwen3LM / Qwen3Embeddings, the Flax
              and HF → torch weight bridges
  ops/        scoring, masked top-k, the sub-tile-max kernel wrappers,
              the two-level select + rescore, rope_prep, flash attention
  index/      DeviceFlatIndex (f32/bf16/int8), Docstore, TorchVectorStore,
              snapshots
  retrieval/  BaseRetriever, VectorStoreRetriever
  rerank/     RerankerBase, CrossEncoderReranker

Every allocating constructor takes an explicit ``device``.
"""

__version__ = "0.1.0"
