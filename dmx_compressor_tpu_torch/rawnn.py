"""Raw (un-quantized) op modules for authoring transformable models.

Port of ``dmx_compressor_tpu/rawnn.py``.  Models are
authored with these light wrappers at the places where a functional op
would otherwise be invisible to the module tree; the substitution pass
(transform/substitute.py) maps each to its Dmx-aware counterpart.  All
wrappers are exact and carry no quantization state.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .functional.simd_ops import rotate_half


class ResAdd(nn.Module):
    def forward(self, x, residual):
        return x + residual


class Mul(nn.Module):
    def forward(self, x, multiplier):
        return x * multiplier


class MatMul(nn.Module):
    """Activation x activation matmul (maps to dmxnn.ActActMatMul)."""

    def forward(self, a, b):
        return torch.matmul(a, b)


class TiedLinear(nn.Module):
    """LM head tied to an embedding table: y = x @ E.T.

    Holds a reference to the embedding module (outside the module tree, so
    the table is registered once), and substitution maps it to a
    dmxnn.Linear whose weight Parameter IS the embedding table."""

    def __init__(self, embed: nn.Embedding):
        super().__init__()
        self.__dict__["embed_ref"] = embed

    def forward(self, x):
        return x @ self.embed_ref.weight.T.to(x.dtype)


class BAddBMM(nn.Module):
    def forward(self, x, batch1, batch2, beta=1, alpha=1):
        return beta * x + alpha * torch.matmul(batch1, batch2)


class Exp(nn.Module):
    def forward(self, x):
        return torch.exp(x)


class Softmax(nn.Module):
    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return torch.softmax(x, dim=self.dim)


class ReLU(nn.Module):
    def forward(self, x):
        return torch.relu(x)


class ReLU6(nn.Module):
    def forward(self, x):
        return torch.clamp(x, 0.0, 6.0)


class SiLU(nn.Module):
    def forward(self, x):
        return torch.nn.functional.silu(x)


# the f32 tanh that XLA computes (Eigen's fast tanh): the input clamped to
# +-7.99881172180175781, where the quotient is exactly +-1, an odd
# polynomial of degree 13 over an even one of degree 6, each evaluated by
# Horner's rule in fused multiply-adds, and tanh(x) = x below 4e-4
_TANH_CLAMP = 7.99881172180175781
_TANH_NUM = (-2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
             5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
             4.89352455891786e-03)
_TANH_DEN = (1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
             4.89352518554385e-03)


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def _horner_fma(x2: torch.Tensor, coeffs) -> torch.Tensor:
    """sum c_i x2^(n-i) by Horner's rule, each step a * b + c rounded once
    to f32 (the product of two f32 is exact in float64)."""
    p = torch.full_like(x2, _f32(coeffs[0]))
    x2d = x2.double()
    for c in coeffs[1:]:
        p = (x2d * p.double() + _f32(c)).float()
    return p


def tanh(x: torch.Tensor) -> torch.Tensor:
    """``jnp.tanh`` of f32 values as XLA computes it on the CPU, bit for
    bit, for a CPU tensor (see ``_TANH_NUM``; tests/test_torch_gemma.py):
    ``torch.tanh`` differs from it in the last bits, and a FLOAT16 cast
    after it then lands one fp16 step apart for some inputs.  For a CUDA
    tensor ``torch.tanh``: the transcription's float64 steps took 66 ms of
    Gemma-2B's 118 ms prefill on an H100 (chip_smoke.py), and the card's
    paths are held against the CPU at a tolerance, not bit for bit."""
    if x.is_cuda:
        return torch.tanh(x)
    xf = x.to(torch.float32)
    xc = torch.clamp(xf, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    t = xc * _horner_fma(x2, _TANH_NUM) / _horner_fma(x2, _TANH_DEN)
    return torch.where(xf.abs() < 0.0004, xf, t).to(x.dtype)


class Tanh(nn.Module):
    def forward(self, x):
        return tanh(x)


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    """``jax.nn.gelu`` written with torch ops: the tanh form
    x * 0.5 (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))) (XLA's tanh, see
    :func:`tanh`), or the exact one 0.5 x erfc(-x / sqrt(2))."""
    if approximate:
        c = float(torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype))
        return x * (0.5 * (1.0 + tanh(c * (x + 0.044715 * (x * x * x)))))
    return 0.5 * x * torch.special.erfc(-x * float(torch.tensor(math.sqrt(0.5), dtype=x.dtype)))


class GELU(nn.Module):
    def __init__(self, approximate: str = "none"):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return gelu(x, self.approximate == "tanh")


class NewGELU(nn.Module):
    def forward(self, x):
        return gelu(x, True)


class FastGELU(nn.Module):
    def forward(self, x):
        return 0.5 * x * (1.0 + tanh(x * 0.7978845608 * (1.0 + 0.044715 * x * x)))


class QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class BloomGELU(nn.Module):
    def forward(self, x):
        return gelu(x, True)


class ClippedGELU(nn.Module):
    """``jax.nn.gelu``'s default (tanh) form, clipped."""

    def __init__(self, min: float = -10, max: float = 10):
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return torch.clamp(gelu(x, True), self.min, self.max)


class Dropout(nn.Module):
    """The inference-mode identity (the Dmx Dropout carries ``p``)."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p

    def forward(self, x):
        return x


class ScaledDotProductAttention(nn.Module):
    """Exact SDPA (maps to the compound dmxnn.ScaledDotProductAttention)."""

    def __init__(self, dropout_p: float = 0.0):
        super().__init__()
        self.dropout_p = dropout_p

    def forward(self, query, key, value, attn_mask=None, is_causal=False, scale=None,
                enable_gqa=False):
        scale_factor = 1.0 / math.sqrt(query.shape[-1]) if scale is None else scale
        if enable_gqa:
            key = torch.repeat_interleave(key, query.shape[-3] // key.shape[-3], dim=-3)
            value = torch.repeat_interleave(value, query.shape[-3] // value.shape[-3], dim=-3)
        logits = torch.matmul(query, key.transpose(-2, -1)) * scale_factor
        L, S = query.shape[-2], key.shape[-2]
        if is_causal:
            causal = torch.ones((L, S), dtype=torch.bool, device=query.device).tril()
            logits = logits.masked_fill(~causal, float("-inf"))
        if attn_mask is not None:
            if attn_mask.dtype == torch.bool:
                logits = logits.masked_fill(~attn_mask, float("-inf"))
            else:
                logits = logits + attn_mask
        return torch.matmul(torch.softmax(logits, dim=-1), value)


class ApplyRotaryPosEmb(nn.Module):
    def forward(self, q, k, cos, sin, unsqueeze_dim=1):
        cos_e = cos.unsqueeze(unsqueeze_dim)
        sin_e = sin.unsqueeze(unsqueeze_dim)
        return q * cos_e + rotate_half(q) * sin_e, k * cos_e + rotate_half(k) * sin_e


class RotaryEmbedding(nn.Module):
    """cos / sin tables of the rotary position embedding, f32 in and out of
    the product ``position * inv_freq``.  ``inv_freq`` is a buffer outside
    the state dict, as in HF's Llama."""

    def __init__(self, dim: int, max_position_embeddings: int = 2048, base: float = 10000.0,
                 attention_scaling: float = 1.0, device=None):
        super().__init__()
        self.dim = dim
        self.max_position_embeddings = max_position_embeddings
        self.base = base
        self.attention_scaling = attention_scaling
        self.register_buffer("inv_freq", inv_freq(dim, base, device), persistent=False)

    def forward(self, x, position_ids):
        return rotary_cos_sin(self.inv_freq, position_ids, self.attention_scaling, x.dtype)


def inv_freq(dim: int, base: float, device=None) -> torch.Tensor:
    """1 / base^(2i / dim), f32 [dim / 2]."""
    return 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def rotary_cos_sin(inv: torch.Tensor, position_ids: torch.Tensor, scaling: float, dtype):
    """(cos, sin) [.., T, dim] of positions [1 or B, T]: the angles
    position * inv_freq in f32, each repeated over both halves."""
    freqs = position_ids[..., None].to(torch.float32) * inv[None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return (torch.cos(emb) * scaling).to(dtype), (torch.sin(emb) * scaling).to(dtype)


class RMSNorm(nn.Module):
    """Raw RMSNorm with a torch-style weight."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.eps = eps

    def forward(self, x):
        xf = x.to(torch.float32)
        y = xf * torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + self.eps)
        return (y * self.weight.to(torch.float32)).to(x.dtype)


class GemmaRMSNorm(nn.Module):
    """Raw Gemma-style (1 + weight) RMSNorm; the weight starts at zero."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim, device=device))
        self.eps = eps

    def forward(self, x):
        xf = x.to(torch.float32)
        y = xf * torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + self.eps)
        return (y * (1.0 + self.weight.to(torch.float32))).to(x.dtype)
