"""Real tokens over the token slots the encoder ran (encoder.pack spans: packing gaps, row and bucket padding), in %."""

from bench_torch import program_spans


def read(run):
    return program_spans.fill_pct(run, "encoder.pack")
