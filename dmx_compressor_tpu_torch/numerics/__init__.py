"""Numerics core: formats, rounding and casts."""

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
from .cast import CastTo, CastToDict, ste
from . import rounding
