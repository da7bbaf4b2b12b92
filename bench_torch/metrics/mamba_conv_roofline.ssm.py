"""The Mamba convolutions' bound (xBC read and written once a live token, bf16, 3.35 TB/s) over the device time inside the mamba_conv ranges, in %."""

from bench_torch import readers_granite4h


def read(run):
    return readers_granite4h.mamba_conv_roofline_pct(run)
