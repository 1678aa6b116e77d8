"""The share of the traced window in which no kernel ran, in %."""

from portbench.metrics import idle


def read(trace):
    return idle(trace)
