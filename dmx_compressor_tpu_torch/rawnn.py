"""Raw (un-quantized) op modules for authoring transformable models.

Port of the wrappers OPT and Llama use from ``dmx_compressor_tpu/rawnn.py``.  Models are
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


class ReLU(nn.Module):
    def forward(self, x):
        return torch.relu(x)


class SiLU(nn.Module):
    def forward(self, x):
        return torch.nn.functional.silu(x)


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
