"""Pipeline parallelism: GPipe microbatching over a ``pp`` mesh axis.

Port of ``dmx_compressor_tpu/parallel/pipeline.py``.  The JAX package
compiles one ``shard_map`` program for every stage, a ``lax.scan`` over the
ticks with ``lax.ppermute`` between stages.  Here each rank is one stage and
runs the same schedule eagerly, tick for tick: with S stages and M
microbatches, ``M + S - 1`` ticks; stage 0 ingests microbatch ``t`` at tick
``t`` (ticks >= M feed the last one again, whose results drain past the
loop unread), stage ``S - 1`` emits microbatch ``t - (S - 1)``, and each
tick's output moves one stage on through :func:`comm.ppermute`.  Only the
last stage's outputs are real: a masked all-reduce over ``pp`` replicates
them.  Bubble fraction ``(S - 1) / (M + S - 1)``.

Gradients flow through it: ``ppermute``'s backward sends the gradient back
a stage, the masked all-reduce's passes it to the last stage only.  As in
JAX, every stage selects its input with ``torch.where`` (stage 0's received
state is in the graph with a zero gradient), so every rank runs the same
sequence of point-to-point transfers backward as forward.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from . import comm
from .mesh import axis_size

__all__ = ["stack_layer_states", "pipeline_forward"]


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return type(trees[0])(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def stack_layer_states(states: Sequence[Any]):
    """Stack per-layer trees of tensors (a decoder layer's ``state_dict()``
    each, say) into one tree with a leading layer dim: the layout
    ``pipeline_forward`` splits over stages."""
    return _map(lambda *xs: torch.stack(xs), *states)


def pipeline_forward(stacked_params, x: torch.Tensor,
                     layer_apply: Callable[[Any, torch.Tensor], torch.Tensor], mesh, *,
                     num_microbatches: int, pp_axis: str = "pp", dp_axis: str | None = None
                     ) -> torch.Tensor:
    """Run ``x`` through L stacked layers, pipelined over ``mesh[pp_axis]``.

    ``stacked_params``: a tree of tensors with leading dim L
    (:func:`stack_layer_states`), the same on every rank; L must divide by
    the number of stages S, and each rank applies its stage's L / S.
    ``x``: [B, ...], the same on every rank, B % num_microbatches == 0;
    with ``dp_axis`` each microbatch is split over it.  ``layer_apply(
    params_i, h) -> h`` applies one layer.  Returns ``layer_L(...
    layer_1(x))`` [B, ...] on every rank, equal to the sequential loop up
    to float reassociation."""
    S, M = axis_size(mesh, pp_axis), num_microbatches
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("pipeline_forward: this rank is not in the mesh")
    L = _leaves(stacked_params)[0].shape[0]
    if L % S:
        raise ValueError(f"{L} layers do not divide into {S} stages")
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} does not divide into {M} microbatches")
    stage = coord[names.index(pp_axis)] if pp_axis in names else 0
    per = L // S
    local = _map(lambda a: a[stage * per:(stage + 1) * per], stacked_params)
    blocks = [_map(lambda a, i=i: a[i], local) for i in range(per)]
    mb = x.reshape((M, B // M) + tuple(x.shape[1:]))
    if dp_axis is not None:
        n, d = axis_size(mesh, dp_axis), coord[names.index(dp_axis)]
        if (B // M) % n:
            raise ValueError(f"microbatch {B // M} does not divide over {dp_axis!r} ({n})")
        w = (B // M) // n
        mb = mb[:, d * w:(d + 1) * w]
    pp_group = mesh.get_group(pp_axis) if S > 1 else None
    first = torch.tensor(stage == 0, device=x.device)
    perm = [(i, i + 1) for i in range(S - 1)]
    state = torch.zeros_like(mb[0])
    outputs = [None] * M
    for t in range(M + S - 1):
        state = torch.where(first, mb[min(t, M - 1)], state)
        out = state
        for p in blocks:
            out = layer_apply(p, out)
        if t - (S - 1) >= 0:
            outputs[t - (S - 1)] = out
        state = comm.ppermute(out, perm, pp_group) if S > 1 else out
    y = torch.stack(outputs)
    if S > 1:
        y = torch.where(torch.tensor(stage == S - 1, device=x.device), y, torch.zeros_like(y))
        y = comm.all_reduce(y, pp_group)
    if dp_axis is not None:
        y = comm.all_gather(y, mesh.get_group(dp_axis), dim=1)
    return y.reshape((B,) + tuple(y.shape[2:]))
