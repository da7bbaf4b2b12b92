"""Host-side utilities: the data model, locks, stage tracing, pooled
readbacks and rank fusion."""
