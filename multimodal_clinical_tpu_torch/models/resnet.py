"""Scratch ResNet18 encoders (port of
``multimodal_clinical_tpu/models/resnet.py``, the BasicBlock path).

Public layout is the JAX one: NHWC in, NHWC out.  Inside, NHWC is permuted
to NCHW, which is exactly ``channels_last``, so the convolutions run
channels_last.  Module names follow the reference's scratch ResNet
(cremad/backbone.py): ``conv1``, ``bn1``, ``layer{1..4}.{b}.conv{1,2}``,
``bn{1,2}``, ``downsample.{0,1}``, so ``models/jax_weights.py`` maps the
flax tree onto them one to one.

Init matches cremad/backbone.py:136-142: kaiming-normal fan-out convs, BN
scale ~ N(1, 0.02), BN bias 0.

The JAX encoder's two kernel switches: ``bn_fused=True`` puts
``FusedBatchNorm`` (the BN-sums kernels) in place of every BN, and
``pool_kernel="pallas"`` makes the stem max-pool the stored-index one
(``ops/maxpool.py``).  The switch keeps the JAX package's value; in the
port it selects the hand-written CUDA kernels.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.maxpool import max_pool_3x3_s2_stored_index
from .common import FusedBatchNorm, TorchBatchNorm, kaiming_normal_fan_out_

POOL_KERNELS = ("xla", "pallas")


def _bn(features: int, dtype: Optional[torch.dtype], fused: bool) -> nn.Module:
    return (FusedBatchNorm if fused else TorchBatchNorm)(features, dtype)


class Conv(nn.Module):
    """Bias-free k x k conv, padding k // 2 (the JAX package's ``_conv``);
    computes in ``dtype``, or in the promotion of input and weight."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.padding = kernel // 2
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        kaiming_normal_fan_out_(self.weight, generator)

    def compute_dtype(self, x: torch.Tensor) -> torch.dtype:
        return self.dtype or torch.promote_types(x.dtype, self.weight.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype(x)
        return F.conv2d(x.to(dtype), self.weight.to(dtype), None,
                        self.stride, self.padding)


class StemConv(Conv):
    """7x7 / stride 2 / pad 3 stem; computes in ``dtype`` or the input's
    dtype (flax ``StemConv``).  The space-to-depth form is not ported."""

    def __init__(self, cin: int, width: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(cin, width, 7, 2, dtype)

    def compute_dtype(self, x: torch.Tensor) -> torch.dtype:
        return self.dtype or x.dtype


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False,
                 dtype: Optional[torch.dtype] = None, bn_fused: bool = False):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, stride, dtype)
        self.bn1 = _bn(planes, dtype, bn_fused)
        self.conv2 = Conv(planes, planes, 3, 1, dtype)
        self.bn2 = _bn(planes, dtype, bn_fused)
        self.downsample = (
            nn.Sequential(Conv(cin, planes, 1, stride, dtype),
                          _bn(planes, dtype, bn_fused))
            if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNetEncoder(nn.Module):
    """Residual feature extractor: (B, H, W, C_in) -> stage-4 feature map
    (B, h, w, 8 * width), NHWC at both ends."""

    def __init__(self, in_channels: int,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2), width: int = 64,
                 dtype: Optional[torch.dtype] = None,
                 stem_space_to_depth: bool = False, bn_fused: bool = False,
                 pool_kernel: str = "xla"):
        super().__init__()
        if stem_space_to_depth:
            raise NotImplementedError(
                "stem_space_to_depth=True is not ported (ROADMAP.md queue A, "
                "item 20)")
        if pool_kernel not in POOL_KERNELS:
            raise ValueError(f"pool_kernel must be one of {POOL_KERNELS}, "
                             f"got {pool_kernel!r}")
        self.pool_kernel = pool_kernel
        self.conv1 = StemConv(in_channels, width, dtype)
        self.bn1 = _bn(width, dtype, bn_fused)
        planes, cin = width, width
        for stage, blocks in enumerate(stage_sizes):
            layer = []
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                # BasicBlock nets change width exactly when striding
                layer.append(BasicBlock(cin, planes, stride, stride != 1,
                                        dtype, bn_fused))
                cin = planes
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))
            planes *= 2
        self.stage_sizes = tuple(stage_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view: channels_last
        x = F.relu(self.bn1(self.conv1(x)))
        if self.pool_kernel == "pallas":
            x = max_pool_3x3_s2_stored_index(
                x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        else:
            x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.permute(0, 2, 3, 1)
