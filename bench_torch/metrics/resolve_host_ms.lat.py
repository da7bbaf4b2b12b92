"""Host ms per TorchVectorStore._resolve call (one query's k hits through the docstore)."""

from bench_torch import readers


def read(run):
    return readers.host_ms_per_call(run, "resolve")
