"""Device ops: scoring, top-k, the sub-tile-max kernel and the two-level search."""
