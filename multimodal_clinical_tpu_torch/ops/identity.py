"""Identity copy of a dense tensor: the plain version of kernel
``ops/cuda_identity.launch_identity`` (``csrc/identity_copy.cu``), the
port of ``tools/probe_pallas_layout.py::pallas_identity``."""

from __future__ import annotations

import torch


def identity(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` with the same shape, dtype and strides
    (``clone`` keeps the strides of a dense, non-overlapping tensor)."""
    return x.clone()
