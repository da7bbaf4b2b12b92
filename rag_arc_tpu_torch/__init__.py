"""rag_arc_tpu_torch — the PyTorch/CUDA port of rag_arc_tpu.

A second package beside ``rag_arc_tpu``: the same layout and names, in
PyTorch, with each TPU kernel on the ported path rewritten by hand for
Hopper (``csrc/``). The JAX package is the reference the port is tested
against; the port itself never imports JAX. It reuses the JAX package's
host-only modules (data model, tokenizer, packing, locks, tracing).

Ported so far — the dense main path:

  models/     TextEncoder / PackedTextEncoder, TorchEncoderEmbeddings,
              the Flax → torch weight bridge
  ops/        scoring, masked top-k, the sub-tile-max kernel wrapper,
              the two-level select + rescore
  index/      DeviceFlatIndex (f32/bf16), Docstore, TorchVectorStore
  retrieval/  BaseRetriever, VectorStoreRetriever

Every allocating constructor takes an explicit ``device``.
"""

__version__ = "0.1.0"
