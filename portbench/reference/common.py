"""Pieces the families' references share."""

from __future__ import annotations

import torch

from . import numerics as N


def causal_attention(q, k, v, scale, dtype):
    """Softmax attention of q [H, T, D] over k, v [H, S, D] (S >= T), query
    t at position S - T + t seeing keys up to it; in ``dtype``."""
    T, S = q.shape[-2], k.shape[-2]
    s = torch.matmul(q.to(dtype), k.to(dtype).transpose(-1, -2)) * scale
    pos = torch.arange(T, device=q.device)[:, None] + S - T
    keep = torch.arange(S, device=q.device)[None, :] <= pos
    s = s.masked_fill(~keep, float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1), v.to(dtype))


def quantized_weight(w, mode, dtype):
    """A linear's weight as the mode serves it: BFP16_64 along the inputs in
    the packed mode."""
    if mode == "weights":
        w = N.bfp(w, 8, 64, axis=-1)
    return w.to(dtype)
