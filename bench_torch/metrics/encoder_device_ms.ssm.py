"""Device ms per encode_device call (the query encoder), from the kernels its range launched."""

from bench_torch import readers


def read(run):
    return readers.device_ms_per_call(run, "encode")
