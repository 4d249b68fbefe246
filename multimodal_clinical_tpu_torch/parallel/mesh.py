"""The device mesh and the batch's placement on it (port of
``multimodal_clinical_tpu/parallel/mesh.py``).

The JAX package jits every step over a named ``("data", "model")`` mesh of
devices and lets GSPMD place the collectives.  Here one process drives one
device, so the mesh is over the ranks of the process group
(``parallel/distributed.py``): the ``data`` axis splits each global batch
into the ranks' rows, and the port issues the data axis's collectives by
hand (``engine/steps.py``, ``models/common.py``).  The ``model`` axis
(tensor parallelism), the ``stage`` axis (GPipe) and sequence sharding are
queued as ROADMAP.md item 18b and raise here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch.distributed as dist

from .distributed import rank, world_size

DATA_AXIS = "data"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"

ITEM_18B = ("the port runs the data axis only; the model axis, the stage "
            "axis and sequence sharding come with ROADMAP.md item 18b")


@dataclasses.dataclass
class Mesh:
    """Axis sizes over the ranks; ``device_mesh`` is the
    ``torch.distributed`` ``DeviceMesh`` named ``("data", "model")`` when a
    process group is up, else None (one process, one device)."""

    shape: Dict[str, int]
    device_mesh: Optional[object] = None

    @property
    def data_group(self):
        """The process group of the data axis, which the steps' collectives
        run over; None where the axis has one rank (no collective)."""
        if self.device_mesh is None or self.shape[DATA_AXIS] == 1:
            return None
        return self.device_mesh.get_group(DATA_AXIS)


def refuse_item_18b(mp: int = 1, pp: int = 1, pipeline_stages: int = 0,
                    sequence_sharding: bool = False) -> None:
    set_ = [name for name, on in (
        ("a model axis > 1", mp > 1), ("a stage axis > 1", pp > 1),
        ("pipeline_stages > 1", int(pipeline_stages or 0) > 1),
        ("sequence_sharding", bool(sequence_sharding))) if on]
    if set_:
        raise NotImplementedError(f"{', '.join(set_)}: {ITEM_18B}")


def make_mesh(mesh_shape: Optional[Dict[str, int]] = None,
              device_type: str = "cpu") -> Mesh:
    """A ``("data", "model")`` mesh over the ranks.  ``mesh_shape`` maps an
    axis to its size, as in the JAX package (the data axis defaults to the
    ranks left over); the sizes must multiply to the world size."""
    n = world_size()
    if mesh_shape:
        mp = int(mesh_shape.get(MODEL_AXIS, 1)) or 1
        pp = int(mesh_shape.get(STAGE_AXIS, 1)) or 1
        dp = int(mesh_shape.get(DATA_AXIS, 0)) or max(1, n // (mp * pp))
    else:
        dp, mp, pp = n, 1, 1
    if dp * mp * pp != n:
        raise ValueError(f"mesh {dp}x{mp}x{pp} != {n} devices")
    refuse_item_18b(mp, pp)
    device_mesh = None
    if dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        device_mesh = init_device_mesh(device_type, (dp, mp),
                                       mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh({DATA_AXIS: dp, MODEL_AXIS: mp}, device_mesh)


def batch_sharding(mesh: Mesh, global_batch: int) -> slice:
    """This rank's rows of a global batch of ``global_batch`` rows.  The
    ``Loader`` feeds a rank its rows and ``data/loader.py::DeviceCopy``
    puts them on its device: there is no global assembly."""
    per = global_batch // mesh.shape[DATA_AXIS]
    return slice(rank() * per, (rank() + 1) * per)


def local_device_count() -> int:
    """Devices this process drives: one."""
    return 1
