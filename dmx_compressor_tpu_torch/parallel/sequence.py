"""Sequence (context) parallelism: ring attention over an ``sp`` mesh axis.

Port of ``dmx_compressor_tpu/parallel/sequence.py``.  Each rank computes
exact attention for its chunk of the queries while the K/V chunks travel
around the ring (:func:`comm.ppermute`), accumulating the flash-attention
online softmax, so no rank materializes the [S, S] logits.  Causal masking
uses global positions.  As in the JAX package it is plain matmuls (JAX's
``einsum``, outside any Pallas kernel); gradients flow through it
(``ppermute``'s backward carries the K/V gradients back around the ring).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import comm
from .mesh import axis_size

__all__ = ["ring_attention"]

_NEG = -1e30


def _ring_local(q, k, v, group, n: int, me: int, causal: bool, scale: float):
    """One rank's body: q / k / v its chunks [B, H, S/n, D]."""
    Sq, Sk = q.shape[2], k.shape[2]
    q_pos = me * Sq + torch.arange(Sq, device=q.device)
    m = torch.full(q.shape[:3], _NEG, dtype=q.dtype, device=q.device)
    l = torch.zeros(q.shape[:3], dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    perm = [(j, (j + 1) % n) for j in range(n)]
    for i in range(n):
        # after i rotations this rank holds the chunk that started at ring
        # position (me - i) mod n
        src = (me - i) % n
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
        pmask = None
        if causal:
            k_pos = src * Sk + torch.arange(Sk, device=q.device)
            valid = k_pos[None, :] <= q_pos[:, None]
            logits = torch.where(valid, logits, torch.full((), _NEG, dtype=q.dtype,
                                                           device=q.device))
            pmask = valid.to(q.dtype)
        new_m = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - new_m[..., None])
        if pmask is not None:
            p = p * pmask  # an exact zero for masked keys even where new_m == _NEG
        alpha = torch.exp(m - new_m)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v)
        m = new_m
        if n > 1:
            k = comm.ppermute(k, perm, group)
            v = comm.ppermute(v, perm, group)
    return o / torch.clamp(l, min=1e-30)[..., None]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                   sp_axis: str = "sp", causal: bool = False, scale: Optional[float] = None,
                   dp_axis: Optional[str] = None) -> torch.Tensor:
    """Exact attention with the sequence split over ``mesh[sp_axis]``.

    q / k / v: [B, H, S, D], the same on every rank, S divisible by the sp
    axis (and B by the dp axis, with ``dp_axis``).  Each rank attends with
    its own chunk of the sequence (and of the batch); the result, gathered
    over both axes, is [B, H, S, D] on every rank.  Memory per rank beyond
    the inputs is O(S / n · D)."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("ring_attention: this rank is not in the mesh")
    S, n = q.shape[2], axis_size(mesh, sp_axis)
    if S % n:
        raise ValueError(f"sequence {S} does not divide over {n} sp ranks")
    scale = float(q.shape[-1]) ** -0.5 if scale is None else scale
    me = coord[names.index(sp_axis)] if sp_axis in names else 0
    w = S // n
    q, k, v = (t.narrow(2, me * w, w) for t in (q, k, v))
    if dp_axis is not None:
        nd, d = axis_size(mesh, dp_axis), coord[names.index(dp_axis)]
        if q.shape[0] % nd:
            raise ValueError(f"batch {q.shape[0]} does not divide over {nd} dp ranks")
        b = q.shape[0] // nd
        q, k, v = (t.narrow(0, d * b, b) for t in (q, k, v))
    group = mesh.get_group(sp_axis) if n > 1 else None
    out = _ring_local(q, k, v, group, n, me, causal, scale)
    if n > 1:
        out = comm.all_gather(out, group, dim=2)
    if dp_axis is not None:
        out = comm.all_gather(out, mesh.get_group(dp_axis), dim=0)
    return out
