"""torchvision-style encoders of Enrico, ResNet18Slim and VGG11Slim, and
the local checkpoint reader (port of
``multimodal_clinical_tpu/models/pretrained.py`` and of
``benchmarks/food101.py::_torch_state_dict``).

Reference: enrico/joint_model.py:12-52 (ResNet18Slim: torchvision resnet18
minus its fc, an average pool and a Linear(512, hiddim) classifier,
optionally frozen features) and enrico/joint_model_counts.py:14-55
(VGG11Slim: torchvision vgg11_bn features with a Dropout after every ReLU,
a 7 x 7 adaptive pool and a Linear(512 * 7 * 7, hiddim)).

Both keep torchvision's ``state_dict`` names, so a local torchvision
checkpoint loads with ``load_state_dict``: ``features`` of ResNet18Slim is
a ``ResNetEncoder`` named as torchvision's resnet18, and ``features`` of
VGG11Slim is torchvision's vgg11_bn index for index (the dropouts are
applied in ``forward`` and hold no state).  No weights are downloaded:
without a local file the towers start from their random init.

``freeze_features`` detaches the feature output, the functional twin of
the JAX package's ``stop_gradient`` and of ``requires_grad=False``: the
frozen parameters' ``.grad`` stays None, and BN running statistics still
update in train mode.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import (
    Dropout, TorchBatchNorm, TorchDense, adaptive_avg_pool2d,
    global_avg_pool, kaiming_normal_fan_out_,
)
from .resnet import ResNetEncoder


class ResNet18Slim(nn.Module):
    """(B, H, W, 3) -> (embedding (B, 8 * width), logits (B, hiddim));
    ``width`` is torchvision's 64 (the tests narrow it)."""

    def __init__(self, hiddim: int, freeze_features: bool = True,
                 dtype: Optional[torch.dtype] = None, width: int = 64):
        super().__init__()
        self.freeze_features = freeze_features
        self.features = ResNetEncoder(3, (2, 2, 2, 2), width, dtype=dtype,
                                      bn_scale_std=0.0)
        self.classifier = TorchDense(8 * width, hiddim, dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        embedding = global_avg_pool(self.features(x))
        if self.freeze_features:
            embedding = embedding.detach()
        return embedding, self.classifier(embedding)


_VGG11_CFG = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M")


class BiasConv(nn.Module):
    """3x3 conv, padding 1, with a bias, in ``dtype`` or the promotion of
    input and weight (flax ``nn.Conv``); torchvision VGG's init:
    kaiming-normal fan-out kernel, zero bias."""

    def __init__(self, cin: int, cout: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        kaiming_normal_fan_out_(self.weight, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.conv2d(x.to(dtype), self.weight.to(dtype),
                        self.bias.to(dtype), 1, 1)


class VGG11Slim(nn.Module):
    """(B, H, W, 3) -> (B, hiddim).  ``features`` is torchvision's
    vgg11_bn stack (conv, BN, ReLU per entry of ``_VGG11_CFG``, a 2 x 2
    max-pool per "M"); with ``dropout`` a ``Dropout(dropout_p)`` follows
    every ReLU."""

    def __init__(self, hiddim: int, dropout: bool = True,
                 dropout_p: float = 0.2, freeze_features: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.freeze_features = freeze_features
        layers, cin = [], 3
        for v in _VGG11_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [BiasConv(cin, v, dtype),
                           TorchBatchNorm(v, dtype, scale_std=0.0),
                           nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)
        self.dropouts = nn.ModuleList(
            Dropout(dropout_p) for _ in range(8 if dropout else 0))
        self.classifier = TorchDense(cin * 7 * 7, hiddim, dtype)
        convs = [i for i, m in enumerate(layers) if isinstance(m, BiasConv)]
        self.flax_names = {
            **{f"features.{t}": f"Conv_{i}" for i, t in enumerate(convs)},
            **{f"features.{t + 1}": f"TorchBatchNorm_{i}"
               for i, t in enumerate(convs)}}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view: channels_last
        drops = iter(self.dropouts)
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU) and self.dropouts:
                x = next(drops)(x)
        x = adaptive_avg_pool2d(x, (7, 7))
        if self.freeze_features:
            x = x.detach()
        return self.classifier(x.flatten(1))  # torch's C-major flatten


def torch_state_dict(path: str) -> Dict:
    """A local torch or HF checkpoint -> its raw state dict.  Takes a file
    (.pth/.bin/.pt/.safetensors) or an HF snapshot directory."""
    if os.path.isdir(path):
        for cand in ("model.safetensors", "pytorch_model.bin"):
            p = os.path.join(path, cand)
            if os.path.exists(p):
                path = p
                break
        else:
            raise FileNotFoundError(
                f"{path}: no model.safetensors / pytorch_model.bin")
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]  # lightning-style wrapper
    return sd
