"""Shared building blocks: torch-matched initialisers, ``TorchDense``,
``TorchBatchNorm``, ``FusedBatchNorm`` and pooling (port of
``multimodal_clinical_tpu/models/common.py``).

Every module here keeps fp32 parameters and computes in a configurable
``dtype`` (bf16 on the main path), casting inputs and weights where the
flax modules do.  Weights are drawn from an explicit ``torch.Generator``
by ``init_weights``; the constructors draw from torch's global generator,
as ``torch.nn`` modules do.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_bn import batch_norm_inference, batch_norm_train_stats
from ..ops.seed_fold import batch_norm
from ..parallel.distributed import axis_group, group_size


def kaiming_normal_fan_out_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """torch kaiming_normal_(mode='fan_out', nonlinearity='relu'): the
    scratch ResNet convs (cremad/backbone.py:137-139)."""
    return nn.init.kaiming_normal_(w, mode="fan_out", nonlinearity="relu",
                                   generator=generator)


def kaiming_uniform_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """torch kaiming_uniform_(a=0), U(-sqrt(6 / fan_in), sqrt(6 / fan_in)):
    the LeNet convs (avmnist/joint_model.py:69-71)."""
    return nn.init.kaiming_uniform_(w, a=0.0, nonlinearity="relu",
                                    generator=generator)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator=None) -> torch.Tensor:
    """flax's default Dense kernel init (``lecun_normal``): a normal of
    variance 1 / fan_in truncated at two standard deviations, its scale
    corrected for the truncation as jax's ``variance_scaling`` does."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
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


class BatchNormBase(nn.Module):
    """Parameters and running statistics of the towers' batch norms: fp32
    ``weight`` (flax ``scale``) and ``bias``, ``running_mean`` and
    ``running_var`` buffers, momentum 0.1 (flax 0.9), eps 1e-5; scale ~
    N(1, ``scale_std``), bias 0: N(1, 0.02) in the scratch ResNet
    (cremad/backbone.py:136-142), ones where ``scale_std`` is 0 (the flax
    default, LeNet's).  ``dtype`` is the compute dtype; subclasses define
    ``forward``, which moves the running statistics in a training pass
    unless ``update_running`` is off (a block's recompute under
    ``frozen_running_stats``)."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None,
                 scale_std: float = 0.02):
        super().__init__()
        self.dtype = dtype
        self.scale_std = scale_std
        self.momentum = 0.1
        self.eps = 1e-5
        self.update_running = True
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        if self.scale_std:
            nn.init.normal_(self.weight, 1.0, self.scale_std,
                            generator=generator)
        else:
            nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)


class TorchBatchNorm(BatchNormBase):
    """BatchNorm with the JAX package's default (flax ``nn.BatchNorm``)
    semantics, which differ from ``torch.nn.BatchNorm2d``: statistics in
    fp32, and the BIASED batch variance goes into ``running_var``.
    ``F.batch_norm`` (``ops/seed_fold.batch_norm`` under the multi-seed
    sweep's vmap) computes the batch statistics into scratch buffers
    (momentum 1 leaves the batch mean and the unbiased variance there) and
    the running buffers are updated here by hand.  Under data parallelism
    (the step's data axis) the statistics are the global batch's, through
    ``ops/fused_bn.py`` with its plain sums summed over the ranks.  The
    output is in ``dtype`` or, when None, in the promotion of the input
    with fp32, as flax's is.  Takes (N, C, ...)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = self.dtype or torch.promote_types(x.dtype,
                                                      self.weight.dtype)
        if not self.training:
            y = batch_norm(x, self.running_mean, self.running_var,
                           self.weight, self.bias, False, 0.0, self.eps)
            return y.to(out_dtype)
        c = x.shape[1]
        if group_size(axis_group()) > 1:
            # data parallelism: the statistics of the global batch, through
            # ops/fused_bn.py with its plain sums summed over the ranks
            y, mean, biased = batch_norm_train_stats(
                x.movedim(1, -1), self.weight, self.bias, self.eps,
                kernels=False)
            if self.update_running:
                self._move_running(mean, biased)
            return y.movedim(-1, 1).to(out_dtype)
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                       self.eps)
        if not self.update_running:
            return y.to(out_dtype)
        m = x.numel() // c
        self._move_running(mean, var * ((m - 1) / m))
        return y.to(out_dtype)

    @torch.no_grad()
    def _move_running(self, mean: torch.Tensor, biased: torch.Tensor):
        self.running_mean.mul_(1.0 - self.momentum).add_(
            mean, alpha=self.momentum)
        self.running_var.mul_(1.0 - self.momentum).add_(
            biased, alpha=self.momentum)


class FusedBatchNorm(BatchNormBase):
    """BatchNorm through ``ops/fused_bn.py`` (the BN-sums kernels on the
    card), with the JAX module's semantics: the output in the input's dtype
    (after a cast to ``dtype`` when given), and torch's UNBIASED variance
    ``var * M / (M - 1)`` into ``running_var``, where the default BN of
    ``models/resnet.py`` stores the biased one.  Parameter and buffer names
    are the default BN's, so the same flax trees load.  Takes (N, C, ...)
    as the towers give it; on a ``channels_last`` map the channels-last
    view that the kernels read is free."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.movedim(1, -1)
        if self.dtype is not None:
            x = x.to(self.dtype)
        if not self.training:
            y = batch_norm_inference(x, self.weight, self.bias,
                                     self.running_mean, self.running_var,
                                     self.eps)
            return y.movedim(-1, 1)
        y, mean, var = batch_norm_train_stats(x, self.weight, self.bias,
                                              self.eps)
        if not self.update_running:
            return y.movedim(-1, 1)
        with torch.no_grad():
            m = x.numel() // x.shape[-1] * group_size(axis_group())
            self.running_mean.mul_(1.0 - self.momentum).add_(
                mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(
                var * (m / max(m - 1, 1)), alpha=self.momentum)
        return y.movedim(-1, 1)


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Inside this block no BatchNorm of ``module`` moves its running
    statistics: a checkpointed block's recompute runs its forward a second
    time for the same step."""
    norms = [m for m in module.modules() if isinstance(m, BatchNormBase)]
    for m in norms:
        m.update_running = False
    try:
        yield
    finally:
        for m in norms:
            m.update_running = True


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


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """``window`` x ``window`` max-pool, stride ``window``, with VALID
    padding (the output size floors) on an (N, C, H, W) map, as the towers
    hold it (the JAX ``max_pool`` takes NHWC)."""
    return F.max_pool2d(x, window)


def adaptive_avg_pool2d(x: torch.Tensor, output_size: Tuple[int, int]
                        ) -> torch.Tensor:
    """torch ``F.adaptive_avg_pool2d`` on an (N, C, H, W) map: bin i covers
    [floor(i * L / out), ceil((i + 1) * L / out)), the bins of the JAX
    package's NHWC ``adaptive_avg_pool2d`` (VGG11Slim's 7 x 7 pool, which
    upsamples where the map is smaller, as Enrico's 8 x 4 is along W)."""
    return F.adaptive_avg_pool2d(x, output_size)


# (shape, keep_prob, device) -> bool keep mask: where a train step draws
# its dropout masks from (``dropout_source``); None means torch's global
# generator
MaskSource = Callable[[Sequence[int], float, torch.device], torch.Tensor]
_DROPOUT_SOURCE: Optional[MaskSource] = None


@contextlib.contextmanager
def dropout_source(source: Optional[MaskSource]):
    """Every ``Dropout`` in train mode draws its keep mask from ``source``
    inside this block, in the order the forward reaches them (the train
    step's per-step generator; a test's injected masks)."""
    global _DROPOUT_SOURCE
    previous, _DROPOUT_SOURCE = _DROPOUT_SOURCE, source
    try:
        yield
    finally:
        _DROPOUT_SOURCE = previous


def draw_keep(shape: Sequence[int], keep_prob: float,
              device: torch.device) -> torch.Tensor:
    """A train-mode dropout's bool keep mask of ``shape``: from the source
    of the enclosing ``dropout_source`` block, else torch's global
    generator."""
    if _DROPOUT_SOURCE is not None:
        return _DROPOUT_SOURCE(tuple(shape), keep_prob, device)
    return torch.rand(tuple(shape), device=device) < keep_prob


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode keep each entry with probability
    1 - p and scale it by 1 / (1 - p), as ``x / keep_prob`` in the input's
    dtype (torch's ``F.dropout`` multiplies by the reciprocal, which rounds
    differently); identity in eval mode."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        keep_prob = 1.0 - self.p
        keep = draw_keep(x.shape, keep_prob, x.device)
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
