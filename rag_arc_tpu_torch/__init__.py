"""rag_arc_tpu_torch — the PyTorch/CUDA port of rag_arc_tpu.

A second package beside ``rag_arc_tpu``: the same layout and names, in
PyTorch, with each TPU kernel on the ported path rewritten by hand for
Hopper (``csrc/``). The JAX package is the reference the port is tested
against; the port itself imports neither JAX nor anything of the JAX
package: it keeps its own copies of the host-only modules it needs (data
model, tokenizer, packing, the embeddings interface, locks, tracing).

Ported so far — the dense main path, the int8 index, the reranker and the
kernel probe:

  models/     TextEncoder / PackedTextEncoder, CausalLM,
              TorchEncoderEmbeddings, Qwen3LM / Qwen3Embeddings, the Flax
              and HF → torch weight bridges
  ops/        scoring, masked top-k, the sub-tile-max kernel wrappers and
              the producer switch (stream, stream_piped, scan), the
              two-level select + rescore, rope_prep, flash attention, the
              fused MIPS top-k, the corpus-stream floor
  index/      DeviceFlatIndex (f32/bf16/int8), Docstore, TorchVectorStore,
              snapshots
  retrieval/  BaseRetriever, VectorStoreRetriever
  rerank/     RerankerBase, CrossEncoderReranker
  tools/      kernel_probe (python -m rag_arc_tpu_torch.tools.kernel_probe)
  utils/      Document, RWLock, stage tracing

Every allocating constructor takes an explicit ``device``.
"""

__version__ = "0.1.0"
