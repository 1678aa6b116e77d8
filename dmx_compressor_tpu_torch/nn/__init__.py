"""Dmx op modules (the subset of the JAX package's zoo that the ported families use)."""

from .core import DmxModule
from .modules import (
    ActActMatMul,
    ApplyRotaryPosEmb,
    Dropout,
    BloomGELU,
    ClippedGELU,
    Embedding,
    FastGELU,
    GELU,
    GELUBase,
    GemmaRMSNorm,
    LayerNorm,
    Linear,
    Mul,
    NewGELU,
    QuickGELU,
    ReLU,
    ResAdd,
    RMSNorm,
    RotaryEmbedding,
    ScaledDotProductAttention,
    SiLU,
    Softmax,
    Tanh,
)
