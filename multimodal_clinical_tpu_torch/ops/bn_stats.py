"""One-pass batch-norm statistics: the plain version of kernel
``ops/cuda_bn_stats.launch_bn_stats`` (``csrc/bn_stats.cu``), the port of
``tools/proto_bn_stats.py::pallas_bn_stats``."""

from __future__ import annotations

from typing import Tuple

import torch


def bn_stats(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., C) feature map -> fp32 per-channel (mean, biased var):
    ``mean = sum(x) / n`` and ``var = sum(x^2) / n - mean^2`` from fp32
    sums over every axis but the last, var not clamped (as the TPU
    probe computes them)."""
    x32 = t.reshape(-1, t.shape[-1]).float()
    n = float(x32.shape[0])
    mean = x32.sum(dim=0) / n
    var = (x32 * x32).sum(dim=0) / n - mean * mean
    return mean, var
