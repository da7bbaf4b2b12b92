"""Share of the window in which the card is idle while an http.request span is open, in %; writes the idle split by innermost program span."""

from bench_torch import program_spans


def read(run):
    return program_spans.inflight_idle_pct(run)
