"""The Mamba scans' bound (5·P·N FLOPs a head and token at the bf16 peak, or x, B, C, dt read and y written once at 3.35 TB/s) over the device time inside the ssd_scan ranges, in %."""

from bench_torch import readers_granite4h


def read(run):
    return readers_granite4h.ssd_roofline_pct(run)
