"""The data axis of the JAX package's ``parallel/``: multi-process
start-up (``distributed.py``), the mesh over the ranks (``mesh.py``) and
FSDP (``sharding.py``).  The model and stage axes are ROADMAP.md item
18b."""

from .distributed import (
    all_reduce_sum_, axis_group, barrier, data_axis, gather_rows,
    global_rows, group_rank, group_size, initialize_if_requested,
    is_primary, rank, rank_rows, world_size,
)
from .mesh import (
    DATA_AXIS, MODEL_AXIS, STAGE_AXIS, Mesh, batch_sharding,
    local_device_count, make_mesh,
)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "STAGE_AXIS", "Mesh", "all_reduce_sum_",
    "axis_group", "barrier", "batch_sharding", "data_axis", "gather_rows",
    "global_rows", "group_rank", "group_size", "initialize_if_requested",
    "is_primary", "local_device_count", "make_mesh", "rank", "rank_rows",
    "world_size",
]
