"""Training-mode BatchNorm with the per-channel sums as kernels (port of
``multimodal_clinical_tpu/ops/fused_bn.py``).

Layout at the public functions is the JAX one, channels last: ``x`` is
(..., C), reduced over every axis but the last.  In the towers it is the
NHWC view of a ``channels_last`` feature map, so (M, C) is a view.

    mean = sum(x) / M
    var  = max(sumsq / M - mean^2, 0)      (one pass, biased)
    y    = x * (scale * rstd) + (bias - mean * scale * rstd)     in fp32
    dbeta = sum(dy),  dgamma = sum(dy * xhat)
    dx   = g * dy - (g / M) * dbeta - (g / M) * dgamma * rstd * (x - mean)

with rstd = rsqrt(var + eps) and g = scale * rstd.  The two sums are
the kernels (``ops/cuda_fused_bn.py``) for a CUDA tensor, the plain
versions here (``channel_sums``, ``bwd_sums``) for a CPU tensor.  The
normalise, apply and dx stay elementwise PyTorch, as the JAX package
leaves them to XLA: each is a mixed-dtype ``torch.addcmul`` that computes
in fp32 and writes the feature dtype, so the forward makes no
full-size fp32 temporary and the backward one (``x - mean``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_fused_bn as cuda
from .seed_fold import fold_seeds_into_channels, unfold_channels


def channel_sums(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel ``launch_channel_sums``: (M, C) -> fp32
    (sum x, sum x^2) per channel (``_channel_sums_jnp``)."""
    x32 = x2d.float()
    return x32.sum(dim=0), (x32 * x32).sum(dim=0)


def bwd_sums(dy2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
             rstd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel ``launch_bwd_sums``: fp32 (sum dy,
    sum dy * xhat) per channel (``_bwd_sums_jnp``)."""
    dy32 = dy2d.float()
    xhat = (x2d.float() - mean) * rstd
    return dy32.sum(dim=0), (dy32 * xhat).sum(dim=0)


def _sums(x: torch.Tensor):
    if x.device.type == "cpu":
        return channel_sums(x.reshape(-1, x.shape[-1]))
    return cuda.launch_channel_sums(x)


def _grad_sums(dy, x, mean, rstd):
    if x.device.type == "cpu":
        c = x.shape[-1]
        return bwd_sums(dy.reshape(-1, c), x.reshape(-1, c), mean, rstd)
    return cuda.launch_bwd_sums(dy, x, mean, rstd)


class _BatchNormTrain(torch.autograd.Function):
    """``_bn_fwd`` / ``_bn_bwd`` of the JAX package's ``custom_vjp``; the
    mean and var outputs carry no gradient.  Under ``torch.func.vmap``
    (the multi-seed sweep) the ``vmap`` rule folds the seed axis into the
    channels: the statistics are per channel, so S seeds' (..., S, C) maps
    normalise as one (..., S * C) map, one launch of each sums kernel for S
    seeds.  On the card that needs S * C within the kernels' ``MAX_C``;
    past it the rule raises.  The fold is a view where the seed axis lies
    next to the channels in memory, as the seed-grouped convolutions leave
    it, and a copy elsewhere."""

    @staticmethod
    def forward(x, scale, bias, eps):
        m = x.numel() // x.shape[-1]
        s, s2 = _sums(x)
        mean = s / m
        var = torch.clamp_min(s2 / m - mean * mean, 0.0)
        rstd = torch.rsqrt(var + eps)
        scale_eff = scale.float() * rstd
        bias_eff = bias.float() - mean * scale_eff
        y = torch.addcmul(bias_eff, x, scale_eff, out=torch.empty_like(x))
        return y, mean, var, rstd

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, _, _ = inputs
        _, mean, var, rstd = output
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.mark_non_differentiable(mean, var, rstd)

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _drstd):
        x, scale, mean, rstd = ctx.saved_tensors
        # the sums read dy's (..., C) view row-major; autograd may hand
        # back another layout (the expanded gradient of a ``.sum()``), so
        # it is copied to that one here, a no-op on the towers' path
        dy = dy.contiguous()
        m = x.numel() // x.shape[-1]
        sum_dy, sum_dy_xhat = _grad_sums(dy, x, mean, rstd)
        g = scale.float() * rstd
        k1 = g / m
        # dx = g * dy - k1 * sum_dy - (k1 * sum_dy_xhat * rstd) * (x - mean)
        xc = torch.sub(x, mean)
        torch.addcmul(-(k1 * sum_dy), xc, -(k1 * sum_dy_xhat * rstd), out=xc)
        dx = torch.addcmul(xc, dy, g, out=torch.empty_like(x))
        return (dx, sum_dy_xhat.to(scale.dtype), sum_dy.to(scale.dtype),
                None)

    @staticmethod
    def vmap(info, in_dims, x, scale, bias, eps):
        seeds = info.batch_size
        x_dim, scale_dim, bias_dim, _ = in_dims
        scale = _per_seed(scale, scale_dim, seeds)
        bias = _per_seed(bias, bias_dim, seeds)
        c = scale.shape[-1]
        if x.device.type != "cpu" and seeds * c > cuda.MAX_C:
            raise ValueError(
                f"bn_fused under vmap folds {seeds} seeds x {c} channels "
                f"into {seeds * c}, past the BN-sums kernels' MAX_C of "
                f"{cuda.MAX_C}: sweep fewer seeds")
        xf, _ = fold_seeds_into_channels(x, x_dim, seeds)
        y, mean, var, rstd = _BatchNormTrain.apply(
            xf, scale.reshape(-1), bias.reshape(-1), eps)
        stats = [t.view(seeds, c) for t in (mean, var, rstd)]
        return ((unfold_channels(y, seeds, c), *stats),
                (y.dim() - 1, 0, 0, 0))


def _per_seed(t: torch.Tensor, bdim, seeds: int) -> torch.Tensor:
    """(S, C) from a per-channel tensor batched at ``bdim`` or shared."""
    return t.expand(seeds, *t.shape) if bdim is None else t.movedim(bdim, 0)


def batch_norm_train_stats(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, eps: float = 1e-5):
    """Training-mode BN over a channels-last (..., C) ``x``: returns
    (y in x's dtype, mean, biased var), the last two fp32 and without
    gradient.  ``y`` is differentiable in (x, scale, bias)."""
    return _BatchNormTrain.apply(x, scale, bias, float(eps))[:3]


def batch_norm_inference(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, mean: torch.Tensor,
                         var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BN from running statistics, in fp32, written in x's dtype."""
    rstd = torch.rsqrt(var.float() + eps)
    scale_eff = scale.float() * rstd
    bias_eff = bias.float() - mean.float() * scale_eff
    if torch._C._functorch.is_batchedtensor(x):
        # vmap takes no out= argument: the fp32 result rounded once to
        # x's dtype, as the mixed-dtype out= write rounds it
        return torch.addcmul(bias_eff, x, scale_eff).to(x.dtype)
    return torch.addcmul(bias_eff, x, scale_eff, out=torch.empty_like(x))
