"""Vector indexes and stores, and the BM25 index."""
