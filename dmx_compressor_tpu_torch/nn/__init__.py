"""Dmx op modules (the OPT and Llama subset of the JAX package's zoo)."""

from .core import DmxModule
from .modules import (
    ActActMatMul,
    ApplyRotaryPosEmb,
    Dropout,
    Embedding,
    LayerNorm,
    Linear,
    Mul,
    ReLU,
    ResAdd,
    RMSNorm,
    RotaryEmbedding,
    ScaledDotProductAttention,
    SiLU,
    Softmax,
)
