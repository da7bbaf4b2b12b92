"""Retrievers."""
