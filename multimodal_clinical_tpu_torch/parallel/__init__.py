"""The port of the JAX package's ``parallel/``: multi-process start-up
(``distributed.py``), the ``("data", "model"[, "stage"])`` mesh over the
ranks (``mesh.py``), the TP, stage and FSDP rules and the sharded state
(``sharding.py``) and GPipe (``pipeline.py``)."""

from .distributed import (
    all_reduce_sum_, axis_group, barrier, copy_to_axis, data_axis,
    gather_from_axis, gather_partial, gather_rows, global_rows, group_rank,
    group_size, initialize_if_requested, is_primary, rank, rank_rows,
    scatter_to_axis, world_size,
)
from .mesh import (
    DATA_AXIS, MODEL_AXIS, STAGE_AXIS, Mesh, batch_sharding,
    constrain_model_parallel, local_device_count, make_mesh,
)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "STAGE_AXIS", "Mesh", "all_reduce_sum_",
    "axis_group", "barrier", "batch_sharding", "constrain_model_parallel",
    "copy_to_axis", "data_axis", "gather_from_axis", "gather_partial",
    "gather_rows", "global_rows", "group_rank", "group_size",
    "initialize_if_requested", "is_primary", "local_device_count",
    "make_mesh", "rank", "rank_rows", "scatter_to_axis", "world_size",
]
