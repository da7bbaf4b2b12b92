"""Host C++ components (the BM25 CSR scorer, the text tokenizer), built
on first use by :func:`rag_arc_tpu_torch.native.build.load_library`."""
