"""Numerics core: formats, rounding, casts, observers, SmoothQuant."""

from .format import (
    Format,
    Same,
    FixedPoint,
    FloatingPoint,
    BlockFloatingPoint,
    ScaledBlockFloatingPoint,
    MXFP,
    MXINT,
)
from .cast import CastTo, CastToDict, DeQuantize, Quantize, ste
from .observer import (
    DummyObserver,
    HistogramObserver,
    MinMaxObserver,
    ObserverBase,
    PercentileObserver,
)
from .smoothquant import ActivationWeightSmoothQuant, SmoothQuant
from . import rounding
