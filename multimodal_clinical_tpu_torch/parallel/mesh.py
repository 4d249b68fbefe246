"""The device mesh and the batch's placement on it (port of
``multimodal_clinical_tpu/parallel/mesh.py``).

The JAX package jits every step over a named ``("data", "model"[,
"stage"])`` mesh of devices and lets GSPMD place the collectives.  Here
one process drives one device, so the mesh is over the ranks of the
process group (``parallel/distributed.py``), laid out as JAX's
``reshape(dp, mp, pp)`` lays out the devices: rank r sits at data
``r // (mp * pp)``, model ``(r // pp) % mp``, stage ``r % pp``.  Each axis
has its process group: the ranks that differ only in that coordinate.
The ``data`` axis splits each global batch into the ranks' rows (ranks
with one data coordinate take the same rows); the ``model`` axis carries
tensor parallelism and sequence sharding, the ``stage`` axis GPipe
(``parallel/pipeline.py``); the port issues each axis's collectives by
hand over its group (``engine/steps.py``, ``models/common.py``,
``parallel/sharding.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from .distributed import rank, scatter_to_axis, world_size

DATA_AXIS = "data"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"


@dataclasses.dataclass
class Mesh:
    """Axis sizes over the ranks (``stage`` only where it is > 1, as in
    the JAX mesh); ``device_mesh`` is the ``torch.distributed``
    ``DeviceMesh`` of those axes when a process group is up, else None
    (one process, one device)."""

    shape: Dict[str, int]
    device_mesh: Optional[object] = None

    def group(self, axis: str):
        """The process group of ``axis``, which its collectives run over;
        None where the axis has one rank (no collective)."""
        if self.device_mesh is None or self.shape.get(axis, 1) == 1:
            return None
        return self.device_mesh.get_group(axis)

    @property
    def data_group(self):
        return self.group(DATA_AXIS)

    @property
    def model_group(self):
        return self.group(MODEL_AXIS)

    @property
    def stage_group(self):
        return self.group(STAGE_AXIS)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        mp = self.shape[MODEL_AXIS]
        pp = self.shape.get(STAGE_AXIS, 1)
        r = rank()
        return {DATA_AXIS: r // (mp * pp), MODEL_AXIS: (r // pp) % mp,
                STAGE_AXIS: r % pp}[axis]


def make_mesh(mesh_shape: Optional[Dict[str, int]] = None,
              device_type: str = "cpu") -> Mesh:
    """A ``("data", "model"[, "stage"])`` mesh over the ranks.
    ``mesh_shape`` maps an axis to its size, as in the JAX package (the
    data axis defaults to the ranks left over); the sizes must multiply to
    the world size.  The stage axis exists only with a size > 1."""
    n = world_size()
    if mesh_shape:
        mp = int(mesh_shape.get(MODEL_AXIS, 1)) or 1
        pp = int(mesh_shape.get(STAGE_AXIS, 1)) or 1
        dp = int(mesh_shape.get(DATA_AXIS, 0)) or max(1, n // (mp * pp))
    else:
        dp, mp, pp = n, 1, 1
    if dp * mp * pp != n:
        raise ValueError(f"mesh {dp}x{mp}x{pp} != {n} devices")
    shape = {DATA_AXIS: dp, MODEL_AXIS: mp}
    if pp > 1:
        shape[STAGE_AXIS] = pp
    device_mesh = None
    if dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        device_mesh = init_device_mesh(device_type, tuple(shape.values()),
                                       mesh_dim_names=tuple(shape))
    return Mesh(shape, device_mesh)


def batch_sharding(mesh: Mesh, global_batch: int) -> slice:
    """This rank's rows of a global batch of ``global_batch`` rows: its
    data coordinate's part (JAX's ``P("data")``).  The ``Loader`` feeds a
    rank its rows and ``data/loader.py::DeviceCopy`` puts them on its
    device: there is no global assembly."""
    per = global_batch // mesh.shape[DATA_AXIS]
    start = mesh.coordinate(DATA_AXIS) * per
    return slice(start, start + per)


def constrain_model_parallel(x: torch.Tensor, spec: Sequence[Optional[str]],
                             mesh: Mesh) -> torch.Tensor:
    """The counterpart of JAX's sharding constraint: this rank's block of
    the replicated ``x`` along each dim that ``spec`` names an axis for
    (``(None, "model")``: the token dim over the model axis), the
    gradient gathered back whole (``scatter_to_axis``).  A dim the axis
    does not divide stays whole, as GSPMD leaves it replicated."""
    for dim, axis in enumerate(spec):
        if axis is None or mesh.shape.get(axis, 1) == 1:
            continue
        if x.shape[dim] % mesh.shape[axis] == 0:
            x = scatter_to_axis(x, dim, mesh.group(axis))
    return x


def local_device_count() -> int:
    """Devices this process drives: one."""
    return 1
