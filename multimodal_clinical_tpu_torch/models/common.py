"""Shared building blocks: torch-matched initialisers, ``TorchDense`` and
pooling (port of ``multimodal_clinical_tpu/models/common.py``).

Every module here keeps fp32 parameters and computes in a configurable
``dtype`` (bf16 on the main path), casting inputs and weights where the
flax modules do.  Weights are drawn from an explicit ``torch.Generator``
by ``init_weights``; the constructors draw from torch's global generator,
as ``torch.nn`` modules do.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def kaiming_normal_fan_out_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """torch kaiming_normal_(mode='fan_out', nonlinearity='relu'): the
    scratch ResNet convs (cremad/backbone.py:137-139)."""
    return nn.init.kaiming_normal_(w, mode="fan_out", nonlinearity="relu",
                                   generator=generator)


def torch_default_uniform_(w: torch.Tensor, fan_in: int,
                           generator=None) -> torch.Tensor:
    """torch Linear default, U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return nn.init.uniform_(w, -bound, bound, generator=generator)


class TorchDense(nn.Module):
    """Linear layer with torch.nn.Linear's default init (weight AND bias ~
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))); weight stored (out, in)."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        fan_in = self.weight.shape[1]
        torch_default_uniform_(self.weight, fan_in, generator)
        torch_default_uniform_(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype),
                        self.bias.to(dtype))


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every parameter of ``model`` from ``generator``, module by
    module in ``model.modules()`` order; running statistics are reset."""
    with torch.no_grad():
        for module in model.modules():
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
    return model


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C) mean over all spatial dims (NHWC)."""
    return x.mean(dim=tuple(range(1, x.dim() - 1)))
