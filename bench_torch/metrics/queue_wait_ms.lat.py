"""Mean ms a request answered in the window waited in the batcher (its batcher.wait spans, submit to the start of its batch)."""

from bench_torch import program_spans


def read(run):
    return program_spans.mean_request_ms(run, ("batcher.wait",), union=True)
