"""The collectives of the rank-local parallel modules, autograd-aware.

The JAX package has no counterpart: there XLA derives every collective from
the shardings (GSPMD) or ``shard_map``'s ``lax.psum`` / ``lax.ppermute``.
The port inserts them by hand, each a ``torch.autograd.Function`` on a
process group:

- :func:`all_reduce` (sum, or max for a global amax): the output is the
  same on every rank, so its backward is the identity (each rank holds the
  same gradient of a replicated value; summing them would count it once per
  rank);
- :func:`all_gather` along a dim, in group-rank order: backward keeps this
  rank's slice of the gradient, for the same reason;
- :func:`copy_to_group`: the identity forward, an all-reduce (sum) of the
  gradient backward (Megatron's ``f``: a replicated input entering a
  column-parallel linear, whose per-rank gradients are partial);
- :func:`ppermute`: ``lax.ppermute``'s counterpart, one batched
  ``isend`` / ``irecv`` per rank; a rank that receives nothing gets zeros,
  and the backward sends the gradient along the reverse permutation.

**Backend.**  With NCCL every collective runs on the card.  A gloo group
all-reduces a CUDA tensor itself, but its all-gather and point-to-point
take CPU tensors only: those move their payload through host memory and
back (a copy each way).  The caller picks the backend; nothing here
switches it.  NCCL refuses two ranks on one card ("Duplicate GPU
detected"), and that error reaches the caller.  Compute never leaves the
tensor's device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["all_reduce", "all_gather", "copy_to_group", "ppermute", "stages_through_host"]


def stages_through_host(t: torch.Tensor, group) -> bool:
    """True where ``group`` is gloo and ``t`` lies on the card: its
    all-gather and point-to-point go through host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=_OPS[op], group=group)
        if op == "max":
            ctx.save_for_backward(x, out)
        ctx.op = op
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.op == "max":
            x, out = ctx.saved_tensors
            return g * (x == out).to(g.dtype), None, None
        return g, None, None


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` (``op`` "sum" or "max"), the same on
    every rank (a group of one runs its collective too)."""
    return _AllReduce.apply(x, op, group)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = x.contiguous()
    host = stages_through_host(src, group)
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if host else out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.size, ctx.size), None, None


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order
    (a group of one runs its collective too)."""
    return _AllGather.apply(x, dim % x.ndim, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; backward, the gradient summed over ``group``.  Only
    where a gradient is wanted (an inference forward skips it)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToGroup.apply(x, group)


def _send_recv(x: torch.Tensor, perm: Sequence[Tuple[int, int]], group) -> torch.Tensor:
    me = dist.get_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: {perm} is not a permutation")
    host = stages_through_host(x, group)
    payload = x.contiguous().cpu() if host else x.contiguous()
    buf = torch.zeros_like(payload)
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, payload, dist.get_global_rank(group, dst[0]), group))
    if src:
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, src[0]), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return buf.to(x.device) if host else buf


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _send_recv(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g, [(d, s) for s, d in ctx.perm], ctx.group), None, None


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]], group: Optional[object]
             ) -> torch.Tensor:
    """``lax.ppermute`` over ``group``: ``perm`` lists (source, destination)
    group ranks; each rank returns what its source sent, or zeros where
    none sends to it."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    if dist.get_world_size(group) == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, perm, group)
