"""Dmx op modules (the OPT subset of the JAX package's zoo)."""

from .core import DmxModule
from .modules import (
    ActActMatMul,
    Dropout,
    Embedding,
    LayerNorm,
    Linear,
    Mul,
    ReLU,
    ResAdd,
    ScaledDotProductAttention,
    Softmax,
)
