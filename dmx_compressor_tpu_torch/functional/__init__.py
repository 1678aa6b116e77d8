"""Approximation taxonomy and the vsimd surrogates (simd_ops)."""

from . import simd_ops
from .approximate import (
    Approximate,
    ApproximationFunction,
    Approximator,
    CustomFunctionApproximation,
    Identity,
    NoApproximation,
    TorchFunctionApproximation,
    approx_blend,
)

# the surrogate library ships in the package (functional/simd_ops.py), as in
# the JAX package
VSIMD_OP_REF_AVAILABLE = True
