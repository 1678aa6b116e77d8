"""Attention's (B3) share of its roofline, in %."""

from portbench.metrics import ATTENTION_KERNELS, roofline


def read(trace):
    return roofline(trace, "attention", ATTENTION_KERNELS)
