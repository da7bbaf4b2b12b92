"""Share of the traced window in which no operation ran on the card, in %."""

from bench_torch import readers


def read(run):
    return readers.idle_pct(run)
