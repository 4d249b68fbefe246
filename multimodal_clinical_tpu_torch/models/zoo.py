"""Fusion networks (port of ``multimodal_clinical_tpu/models/zoo.py``;
slice 1 has ``CremadFusionNet``).  ``forward(*modality_inputs)`` returns
``{"logits": [per-modality (B, C) logits]}``; fusion and losses live in
``engine/contracts.py``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .common import TorchDense, global_avg_pool
from .resnet import ResNetEncoder


class CremadFusionNet(nn.Module):
    """Scratch ResNet18 audio + visual for Crema-D / AVE / VGGSound
    (cremad/joint_model.py:14-60).

    x1: (B, F, T, 1) log-spectrogram; x2: (B, T, H, W, 3) frames.  Time is
    folded into the batch for the visual tower (backbone.py:178-181) and
    pooled jointly with space afterwards (joint_model.py:43-50).  ``width``
    is the stem width of both towers (64 in the reference; the tests narrow
    it).  ``pool_kernel`` is the towers' stem max-pool (see
    ``ResNetEncoder``).
    """

    def __init__(self, num_classes: int, dtype: Optional[torch.dtype] = None,
                 width: int = 64, pool_kernel: str = "xla"):
        super().__init__()
        self.x1_model = ResNetEncoder(1, width=width, dtype=dtype,
                                      pool_kernel=pool_kernel)
        self.x2_model = ResNetEncoder(3, width=width, dtype=dtype,
                                      pool_kernel=pool_kernel)
        self.x1_classifier = TorchDense(8 * width, num_classes, dtype)
        self.x2_classifier = TorchDense(8 * width, num_classes, dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        a = global_avg_pool(self.x1_model(x1))                 # (B, 8w)
        b, t = x2.shape[:2]
        v = self.x2_model(x2.flatten(0, 1))                    # (B*T, h, w, 8w)
        v = v.unflatten(0, (b, t)).mean(dim=(1, 2, 3))         # over (T, h, w)
        return {"logits": [self.x1_classifier(a), self.x2_classifier(v)]}
