"""Model FLOPs of the window's completed work (``work/``) over the window's
seconds at 989 TFLOP/s, in %."""

from portbench.metrics import mfu


def read(trace):
    return mfu(trace)
