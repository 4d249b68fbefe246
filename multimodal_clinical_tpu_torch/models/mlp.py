"""MLP encoders (port of ``multimodal_clinical_tpu/models/mlp.py``).

``MimicMLP``: the static-EHR tower, reference mimic/joint_model.py:11-38
(5 -> 128 -> 64 -> 32 -> C, ReLU between, torch-default Linear init).
``HeadMLP``: the Food101 classification head, reference
food101/joint_model.py:10-24 (in -> hidden -> hidden -> C, ReLU and
Dropout(0.2) after each hidden layer, torch-default Linear init).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import Dropout, TorchDense


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


class HeadMLP(nn.Module):
    """(B, in_features) -> (B, num_classes).  ``mlp`` is the reference's
    ``nn.Sequential`` index for index (Linear, ReLU, Dropout, Linear, ReLU,
    Dropout, Linear); its Linears are the flax ``TorchDense_{0,1,2}``.  The
    dropouts draw from the train step's mask source (``common.Dropout``)."""

    def __init__(self, num_classes: int, in_features: int = 768,
                 hidden_dim: int = 512, dropout_p: float = 0.2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mlp = nn.Sequential(
            TorchDense(in_features, hidden_dim, dtype), nn.ReLU(),
            Dropout(dropout_p),
            TorchDense(hidden_dim, hidden_dim, dtype), nn.ReLU(),
            Dropout(dropout_p),
            TorchDense(hidden_dim, num_classes, dtype))
        self.flax_names = {f"mlp.{t}": f"TorchDense_{i}"
                           for i, t in enumerate((0, 3, 6))}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)
