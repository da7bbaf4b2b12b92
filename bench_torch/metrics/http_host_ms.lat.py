"""Mean host ms a request answered in the window spent in http.parse (body, JSON, validation) and http.serialise (document JSON, dumps, write)."""

from bench_torch import program_spans


def read(run):
    return program_spans.mean_request_ms(run, ("http.parse", "http.serialise"))
