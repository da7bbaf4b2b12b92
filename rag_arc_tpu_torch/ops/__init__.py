"""Device ops: scoring, top-k, the sub-tile-max producers, the two-level
search, rope_prep, flash attention, the fused top-k, the corpus stream,
the BM25 programs, RRF over positions, k-means, the IVF probe scan and
the decoders' residual add + RMSNorm."""
