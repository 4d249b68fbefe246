"""Fusion networks (port of ``multimodal_clinical_tpu/models/zoo.py``):
``CremadFusionNet``, ``AVMnistFusionNet``, ``MimicFusionNet`` and
``MustardFusionNet``.  ``forward(*modality_inputs)`` returns ``{"logits":
[per-modality (B, C) logits]}``; fusion and losses live in
``engine/contracts.py``.  The towers are ``x1_model``, ``x2_model``, ...
(the reference's attribute contract, which OGM-GE and the metrics
address)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import TorchDense, global_avg_pool
from .lenet import LeNet
from .mlp import MimicMLP
from .resnet import ResNetEncoder
from .rnn import GRUNet, LstmClassifier


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


class AVMnistFusionNet(nn.Module):
    """LeNet pair for AV-MNIST (avmnist/joint_model.py:101-130).

    x1: (B, 28, 28, 1) image; x2: (B, 112, 112, 1) spectrogram.  The
    reference applies ReLU to each encoder's output before its head.
    """

    def __init__(self, num_classes: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.x1_model = LeNet(1, 6, 3, dtype)
        self.x2_model = LeNet(1, 6, 5, dtype)
        self.classifier_x1 = TorchDense(self.x1_model.out_features,
                                        num_classes, dtype)
        self.classifier_x2 = TorchDense(self.x2_model.out_features,
                                        num_classes, dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        h1 = F.relu(self.x1_model(x1))
        h2 = F.relu(self.x2_model(x2))
        return {"logits": [self.classifier_x1(h1), self.classifier_x2(h2)]}


class MimicFusionNet(nn.Module):
    """MLP (static 5-dim) + GRU (24 x 12 time series) for MIMIC
    (mimic/joint_model.py:72-125)."""

    def __init__(self, num_classes: int, gru_hidden_dim: int = 32,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.x1_model = MimicMLP(num_classes, dtype=dtype)
        self.x2_model = GRUNet(12, gru_hidden_dim, num_classes, dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        return {"logits": [self.x1_model(x1), self.x2_model(x2)]}


class MustardFusionNet(nn.Module):
    """Three LstmClassifiers (vision 371 / audio 81 / text 300 GloVe) for
    MUsTARD (mustard/joint_model.py:45-83)."""

    def __init__(self, num_classes: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        for i, f in enumerate((371, 81, 300)):
            self.add_module(f"x{i + 1}_model",
                            LstmClassifier(f, num_classes, dtype=dtype))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, x3: torch.Tensor):
        return {"logits": [self.x1_model(x1), self.x2_model(x2),
                           self.x3_model(x3)]}
