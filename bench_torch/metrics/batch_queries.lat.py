"""Queries the batcher hands the pipeline per batch (QueryBatcher.stats deltas over the window)."""

from bench_torch import readers


def read(run):
    return readers.queries_per_batch(run)
