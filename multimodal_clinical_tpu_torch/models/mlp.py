"""MLP encoders (port of ``multimodal_clinical_tpu/models/mlp.py``).

``MimicMLP``: the static-EHR tower, reference mimic/joint_model.py:11-38
(5 -> 128 -> 64 -> 32 -> C, ReLU between, torch-default Linear init).
``HeadMLP`` comes with Food101 (ROADMAP.md queue A, item 15).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import TorchDense


class MimicMLP(nn.Module):
    """(B, in_features) -> (B, num_classes); ``layers.i`` is the flax
    ``TorchDense_i``."""

    def __init__(self, num_classes: int, in_features: int = 5,
                 hidden: Sequence[int] = (128, 64, 32),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        widths = [in_features, *hidden, num_classes]
        self.layers = nn.ModuleList(
            TorchDense(a, b, dtype) for a, b in zip(widths, widths[1:]))
        self.flax_names = {f"layers.{i}": f"TorchDense_{i}"
                           for i in range(len(self.layers))}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)
