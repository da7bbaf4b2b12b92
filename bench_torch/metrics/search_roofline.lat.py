"""The searches' bound (2·B·N·d at the bf16 peak, or the rows read once at the HBM rate) over their kernels' device time, in %."""

from bench_torch import readers


def read(run):
    return readers.search_roofline_pct(run)
