"""Process startup and data feeding across ranks.

Port of ``dmx_compressor_tpu/parallel/distributed.py``.  Where the JAX
package calls ``jax.distributed.initialize`` and lays a global mesh over
ICI within a slice and DCN across hosts, the port starts one process per
rank with ``torch.distributed.init_process_group`` (nothing on the machine
announces a cluster: the caller gives the address, the world size and the
rank) and lays its ``DeviceMesh`` with the data axis across nodes and the
model axes within one.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import NamedSharding, P, make_mesh

__all__ = ["initialize", "pod_mesh", "host_local_batch"]


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None) -> None:
    """Join the process group (a no-op for one process): ``coordinator_address``
    ``"host:port"`` (``tcp://`` rendezvous), ``num_processes`` ranks, this
    one ``process_id``.  ``backend`` defaults to NCCL where a card is
    present, else gloo; it is never switched behind the caller's back (NCCL
    refuses two ranks on one card: pass ``backend="gloo"`` there)."""
    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def pod_mesh(dcn_axis: str = "dp", ici_axes: Sequence[str] = ("tp",),
             ici_shape: Optional[Sequence[int]] = None, ranks_per_node: Optional[int] = None):
    """A mesh with the data axis over nodes and the model axes within a
    node, so only ``dcn_axis`` (gradient / batch) traffic crosses nodes.
    ``ranks_per_node`` defaults to ``LOCAL_WORLD_SIZE`` (torchrun's), else
    the node's card count, else the whole world."""
    world = dist.get_world_size()
    per = ranks_per_node or int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or (
        torch.cuda.device_count() or world)
    if ici_shape is None:
        ici_shape = (per,) if len(ici_axes) == 1 else None
    if ici_shape is None or int(np.prod(ici_shape)) != per or world % per:
        raise ValueError(f"ici_shape {ici_shape} does not cover {per} ranks a node "
                         f"(world {world})")
    return make_mesh((world // per, *ici_shape), (dcn_axis, *ici_axes))


def host_local_batch(global_batch, mesh, data_axis: str = "dp") -> torch.Tensor:
    """This rank's share of ``global_batch`` (a numpy array or tensor, the
    same on every rank) split over ``data_axis`` along its first dim."""
    t = global_batch if torch.is_tensor(global_batch) else torch.from_numpy(
        np.ascontiguousarray(global_batch))
    return NamedSharding(mesh, P(data_axis)).local(t)
