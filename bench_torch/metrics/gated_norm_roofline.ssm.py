"""The gated norms' bound (y and z read and the output written once a live token, bf16, 3.35 TB/s) over the device time inside the gated_rms_norm ranges, in %."""

from bench_torch import readers_granite4h


def read(run):
    return readers_granite4h.gated_norm_roofline_pct(run)
