"""Tensor, data, pipeline and sequence parallelism over ``torch.distributed``
(port of ``dmx_compressor_tpu/parallel``): rank-local shards with explicit
collectives in place of GSPMD's placements (see ``mesh.py``)."""

from .mesh import (
    make_mesh,
    shard_state,
    spec_for_path,
    data_sharding,
    TRANSFORMER_RULES,
)
from .distributed import initialize, pod_mesh, host_local_batch
from .pipeline import pipeline_forward, stack_layer_states
from .sequence import ring_attention
