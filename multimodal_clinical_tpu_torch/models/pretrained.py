"""torchvision-style encoders of Enrico, ResNet18Slim and VGG11Slim, and
the local checkpoint reader (port of
``multimodal_clinical_tpu/models/pretrained.py`` and of
``benchmarks/food101.py::_torch_state_dict``, with a reader of
``.safetensors`` files of its own).

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

import json
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
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
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]  # lightning-style wrapper
    return sd


@torch.no_grad()
def copy_by_name(state: Mapping, module: nn.Module, prefix: str = "",
                 what: str = "checkpoint") -> nn.Module:
    """Copy every entry of ``module.state_dict()`` from ``state`` (numpy
    or tensor values, keyed ``prefix`` + the module's name), in place;
    raises on a missing key or a shape mismatch.  Keys of ``state`` the
    module has no place for are ignored."""
    for key, param in module.state_dict().items():
        if prefix + key not in state:
            raise KeyError(f"{what} state_dict has no {prefix + key!r}")
        value = state[prefix + key]
        if not torch.is_tensor(value):
            value = torch.from_numpy(np.asarray(value))
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{prefix + key}: checkpoint shape "
                             f"{tuple(value.shape)} != model shape "
                             f"{tuple(param.shape)}")
        param.copy_(value)
    return module


# safetensors dtype names -> little-endian numpy dtypes; BF16 is read as
# its 16 bits and widened to fp32
_SAFETENSORS_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2",
                       "BF16": "<u2", "I64": "<i8", "I32": "<i4",
                       "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file -> {name: numpy array}: an 8-byte
    little-endian header length, a JSON header of {name: {"dtype",
    "shape", "data_offsets"}} (and an optional ``__metadata__``), then the
    raw little-endian tensors, offsets counted from the header's end.
    BF16 tensors come back as fp32 (numpy has no bf16); every other dtype
    as stored."""
    with open(path, "rb") as f:
        (size,) = np.frombuffer(f.read(8), "<u8")
        header = json.loads(f.read(int(size)))
        data = np.fromfile(f, np.uint8)
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        kind = info["dtype"]
        if kind not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has unsupported dtype {kind}")
        start, end = info["data_offsets"]
        arr = data[start:end].view(_SAFETENSORS_DTYPES[kind]).reshape(
            info["shape"])
        if kind == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        elif not arr.flags.aligned:
            arr = arr.copy()
        out[name] = arr
    return out
