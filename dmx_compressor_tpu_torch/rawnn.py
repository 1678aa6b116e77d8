"""Raw (un-quantized) op modules for authoring transformable models.

Port of the wrappers OPT uses from ``dmx_compressor_tpu/rawnn.py``.  Models are
authored with these light wrappers at the places where a functional op
would otherwise be invisible to the module tree; the substitution pass
(transform/substitute.py) maps each to its Dmx-aware counterpart.  All
wrappers are exact and carry no quantization state.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class ResAdd(nn.Module):
    def forward(self, x, residual):
        return x + residual


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
