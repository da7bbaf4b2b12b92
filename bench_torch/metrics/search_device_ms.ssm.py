"""Device ms per DeviceFlatIndex.search_device call."""

from bench_torch import readers


def read(run):
    return readers.device_ms_per_call(run, "search")
