"""The short convolutions' bound (B, C, x read and y written once a live token, bf16, at 3.35 TB/s) over the device time inside short_conv, in %."""

from bench_torch import readers_moe


def read(run):
    return readers_moe.short_conv_roofline_pct(run)
