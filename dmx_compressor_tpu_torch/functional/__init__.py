"""Approximation taxonomy and the vsimd surrogates OPT uses (simd_ops)."""

from .approximate import (
    Approximate,
    ApproximationFunction,
    Approximator,
    CustomFunctionApproximation,
    NoApproximation,
    TorchFunctionApproximation,
)
