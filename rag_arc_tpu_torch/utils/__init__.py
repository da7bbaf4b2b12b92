"""Host-side utilities: the data model, locks and stage tracing."""
