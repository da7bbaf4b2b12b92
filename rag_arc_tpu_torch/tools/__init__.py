"""Command-line tools of the port (``python -m rag_arc_tpu_torch.tools.<name>``)."""
