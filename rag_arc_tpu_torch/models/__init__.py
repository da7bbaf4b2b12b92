"""Text encoder and embeddings."""
