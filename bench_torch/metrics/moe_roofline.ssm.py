"""The held experts' FFN bound (the held assignments at 989 TFLOP/s, or the held expert weights read once a layer call at 3.35 TB/s) over the device time inside the moe_experts ranges, in %."""

from bench_torch import readers_granite4h


def read(run):
    return readers_granite4h.moe_roofline_pct(run)
