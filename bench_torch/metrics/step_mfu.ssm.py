"""Model FLOPs (the parameters active on this card) of the work completed in the window over the window at the bf16 peak, in %."""

from bench_torch import readers


def read(run):
    return readers.step_mfu_pct(run)
