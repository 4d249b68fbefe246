"""The multi-seed sweep's fold of the seed axis into the channels, shared
by the ``vmap`` rules of the stored-index max-pool (``ops/maxpool.py``),
the BN-sums BatchNorm (``ops/fused_bn.py``) and the default BatchNorm
(``batch_norm`` here): each is per channel, so S seeds' maps compute as
one map of S * C channels, one kernel launch for S seeds.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def fold_seeds_into_channels(x: torch.Tensor, bdim: Optional[int],
                             seeds: int) -> Tuple[torch.Tensor, int]:
    """(x as (..., S * C), C) from a batched channels-last ``x`` whose seed
    axis is ``bdim`` (None: the same map for every seed): the seed axis
    moved next to the channels and merged into them, a view where memory
    already holds (..., S, C) and a copy elsewhere."""
    if bdim is None:
        x = x.unsqueeze(-2).expand(*x.shape[:-1], seeds, x.shape[-1])
    else:
        x = x.movedim(bdim, -2)
    c = x.shape[-1]
    return x.reshape(*x.shape[:-2], seeds * c).contiguous(), c


def unfold_channels(y: torch.Tensor, seeds: int, c: int) -> torch.Tensor:
    """(..., S * C) -> (..., S, C): the seed axis at ``y.dim() - 1``."""
    return y.view(*y.shape[:-1], seeds, c)


def _fold_nchw(x: torch.Tensor, bdim: Optional[int],
               seeds: int) -> torch.Tensor:
    """(N, C, ...) maps of S seeds batched at ``bdim`` -> (N, S * C, ...)."""
    x = (x.unsqueeze(1).expand(x.shape[0], seeds, *x.shape[1:])
         if bdim is None else x.movedim(bdim, 1))
    return x.reshape(x.shape[0], seeds * x.shape[2], *x.shape[3:])


def _fold_channels(t: Optional[torch.Tensor], bdim: Optional[int],
                   seeds: int) -> Optional[torch.Tensor]:
    """(C,) per-seed vectors batched at ``bdim`` -> (S * C,): a view of the
    stacked (S, C) tensor, so what ``F.batch_norm`` writes into a
    statistics buffer reaches the seeds' own."""
    if t is None:
        return None
    t = t.expand(seeds, *t.shape) if bdim is None else t.movedim(bdim, 0)
    return t.reshape(-1)


class _SeedFoldedBatchNorm(torch.autograd.Function):
    """``F.batch_norm`` under the sweep's vmap.  vmap's own batching rule
    for it takes no fp32 weight or statistics beside a bf16 input (it
    raises "expected scalar type BFloat16 but found Float"), where the
    unbatched op does; this rule folds the seed axis into the channels and
    calls ``F.batch_norm`` once on the (N, S * C, ...) map with the
    (S * C,) weight, bias and statistics, so autograd records that call and
    its own backward.  Only the vmap rule runs."""

    @staticmethod
    def forward(x, mean, var, weight, bias, training, momentum, eps):
        raise RuntimeError("seed_folded_batch_norm runs under vmap only")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, dy):
        raise RuntimeError("seed_folded_batch_norm runs under vmap only")

    @staticmethod
    def vmap(info, in_dims, x, mean, var, weight, bias, training, momentum,
             eps):
        seeds = info.batch_size
        xf = _fold_nchw(x, in_dims[0], seeds)
        mean, var, weight, bias = (
            _fold_channels(t, d, seeds)
            for t, d in zip((mean, var, weight, bias), in_dims[1:5]))
        y = F.batch_norm(xf, mean, var, weight, bias, training, momentum, eps)
        return y.unflatten(1, (seeds, -1)), 1


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.1, eps=1e-5) -> torch.Tensor:
    """``F.batch_norm``, through ``_SeedFoldedBatchNorm`` where ``x`` is
    batched by ``torch.func.vmap`` (the multi-seed sweep)."""
    if torch._C._functorch.is_batchedtensor(x):
        return _SeedFoldedBatchNorm.apply(x, running_mean, running_var,
                                          weight, bias, training, momentum,
                                          eps)
    return F.batch_norm(x, running_mean, running_var, weight, bias, training,
                        momentum, eps)
