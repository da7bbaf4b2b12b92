"""Rerankers: the yes/no cross-encoder over a causal LM."""
