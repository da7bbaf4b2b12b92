"""Host ms an encode call spent in encoder.tokenize and encoder.pack (packing, padding); writes the ingest window's idle split by innermost program span."""

from bench_torch import program_spans


def read(run):
    got = program_spans.idle_split(run, "store.add")
    if got is not None:
        program_spans.report_split(*got, "ingest")
    return program_spans.host_ms_per_call(run, "encoder.tokenize", "encoder.tokenize",
                                          "encoder.pack")
