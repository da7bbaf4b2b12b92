"""The causal attention's bound at the pairs' real lengths over the device time of the Granite attention layers' flash calls, in %."""

from bench_torch import readers


def read(run):
    return readers.attention_roofline_pct(run)
