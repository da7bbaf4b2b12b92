"""Vector indexes (flat, IVF, HNSW) and stores, and the BM25 index."""
