"""Position-id / causal-mask helpers.

Port of ``dmx_compressor_tpu/models/positions.py``.  ``position_offset`` is a
python int (one offset for the whole batch) or an int tensor [B] (per-row
fill points).  The mask keeps the additive ``-1e4`` of the JAX package.
"""

from __future__ import annotations

import torch


def is_per_row(position_offset) -> bool:
    return isinstance(position_offset, torch.Tensor) and position_offset.ndim == 1


def resolve_positions(T: int, position_offset, device=None):
    """Position ids for a length-T step: ``([1, T] or [B, T], per_row)``."""
    if is_per_row(position_offset):
        off = position_offset.to(torch.int64)
        return torch.arange(T, device=off.device)[None, :] + off[:, None], True
    return (torch.arange(T, device=device) + position_offset)[None], False


def causal_mask(T: int, S: int, position_offset, dtype, device=None, sliding_window=None):
    """Additive causal mask: [T, S] for a shared offset, [B, 1, T, S] for
    per-row offsets; banded where ``sliding_window`` is set (a query at p
    sees the keys in (p - sliding_window, p], Mistral's window)."""
    if is_per_row(position_offset):
        off = position_offset.to(torch.int64)
        device = off.device
        qpos = (torch.arange(T, device=device)[None, :] + off[:, None])[:, None, :, None]
        k = torch.arange(S, device=device)[None, None, None, :]
    else:
        qpos = (torch.arange(T, device=device) + position_offset)[:, None]
        k = torch.arange(S, device=device)[None, :]
    keep = k <= qpos
    if sliding_window is not None:
        keep = keep & (k > qpos - sliding_window)
    zeros = torch.zeros(keep.shape, dtype=dtype, device=device)
    return zeros.masked_fill(~keep, -1e4)
