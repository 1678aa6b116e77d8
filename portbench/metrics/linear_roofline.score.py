"""The packed linears' (B1, T1) share of their roofline, in %."""

from portbench.metrics import LINEAR_KERNELS, roofline


def read(trace):
    return roofline(trace, "linear", LINEAR_KERNELS)
