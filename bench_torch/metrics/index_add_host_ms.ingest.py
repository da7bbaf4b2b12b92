"""Host ms per ingest batch in DeviceFlatIndex.add and the docstore's add."""

from bench_torch import readers


def read(run):
    return readers.host_ms_per_call(run, "index_add", "docstore_add")
