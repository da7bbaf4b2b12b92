"""The expert FFN's bound (the live tokens' assignments at 989 TFLOP/s, or the expert weights read once a layer call at 3.35 TB/s) over the device time inside the moe_experts ranges, in %."""

from bench_torch import readers_moe


def read(run):
    return readers_moe.moe_roofline_pct(run)
