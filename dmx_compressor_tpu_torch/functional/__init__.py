"""Approximation taxonomy (the vsimd surrogates come in a later slice)."""

from .approximate import (
    Approximate,
    ApproximationFunction,
    CustomFunctionApproximation,
    NoApproximation,
    TorchFunctionApproximation,
)
