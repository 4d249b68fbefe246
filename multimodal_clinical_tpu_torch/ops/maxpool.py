"""3x3 / stride 2 / pad 1 max-pool with a stored-index backward (port of
``multimodal_clinical_tpu/ops/maxpool_pallas.py::max_pool_3x3_s2_pallas``).

Layout at the public op is the JAX one, (B, H, W, C).  The forward keeps,
beside the maximum, the tap index 0..8 (row-major, -inf padding) of the
FIRST maximal element of each window, as uint8; the backward routes dy
through it by the four parity classes of the input pixel, without
re-reading the input.  Gradients route as ``MaxPool2d(3, 2, 1)`` and XLA's
select-and-scatter route them.  The two steps are the kernels
(``ops/cuda_maxpool.py``) for a CUDA tensor, the plain versions here
(``pool_fwd``, ``pool_bwd``) for a CPU tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import cuda_maxpool as cuda
from .cuda_maxpool import pooled_size
from .seed_fold import fold_seeds_into_channels, unfold_channels


def pool_fwd(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel ``launch_pool_fwd``: (B, H, W, C) ->
    (y, uint8 idx), each (B, ceil(H/2), ceil(W/2), C) (``_fwd_kernel``)."""
    b, h, w, c = x.shape
    ho, wo = pooled_size(h), pooled_size(w)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=float("-inf"))

    def tap(a, s):
        return xp[:, a:a + 2 * ho - 1:2, s:s + 2 * wo - 1:2]

    y = tap(0, 0)
    idx = torch.zeros(y.shape, dtype=torch.uint8, device=x.device)
    for t in range(1, 9):
        v = tap(*divmod(t, 3))
        idx = torch.where(v > y, t, idx)
        y = torch.maximum(y, v)
    return y.contiguous(), idx


def pool_bwd(dy: torch.Tensor, idx: torch.Tensor, h: int,
             w: int) -> torch.Tensor:
    """Plain version of kernel ``launch_pool_bwd``: dx (B, h, w, C) in
    dy's dtype, summed in fp32 in ``_bwd_kernel``'s order."""
    b, ho, wo, c = dy.shape
    # one extra window row and column, never chosen (index 9 matches no tap)
    d = F.pad(dy.float(), (0, 0, 0, 1, 0, 1))
    ix = F.pad(idx, (0, 0, 0, 1, 0, 1), value=9)

    def tap(t, r0, c0):
        dv = d[:, r0:r0 + ho, c0:c0 + wo]
        return torch.where(ix[:, r0:r0 + ho, c0:c0 + wo] == t, dv, 0.0)

    # dx[2r + p, 2s + q]: parity (p, q) decides which taps of which windows
    ee = tap(4, 0, 0)
    eo = tap(5, 0, 0) + tap(3, 0, 1)
    oe = tap(7, 0, 0) + tap(1, 1, 0)
    oo = tap(8, 0, 0) + tap(6, 0, 1) + tap(2, 1, 0) + tap(0, 1, 1)
    even = torch.stack([ee, eo], dim=3).reshape(b, ho, 2 * wo, c)
    odd = torch.stack([oe, oo], dim=3).reshape(b, ho, 2 * wo, c)
    dx = torch.stack([even, odd], dim=2).reshape(b, 2 * ho, 2 * wo, c)
    return dx[:, :h, :w].to(dy.dtype).contiguous()


class _StoredIndexMaxPool(torch.autograd.Function):
    """Forward saves only the uint8 index and the input's H and W.  Under
    ``torch.func.vmap`` (the multi-seed sweep) the ``vmap`` rule folds the
    seed axis into the channels: pooling is per channel, so S seeds' maps
    (B, H, W, S, C) pool as one (B, H, W, S * C) map, one launch of each
    kernel for S seeds.  The fold is a view where the seed axis lies next
    to the channels in memory, as the seed-grouped convolutions leave it,
    and a copy elsewhere."""

    @staticmethod
    def forward(x):
        if x.device.type == "cpu":
            return pool_fwd(x)
        return cuda.launch_pool_fwd(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        (x,) = inputs
        _, idx = output
        ctx.save_for_backward(idx)
        ctx.mark_non_differentiable(idx)
        ctx.hw = x.shape[1:3]

    @staticmethod
    def backward(ctx, dy, _didx):
        (idx,) = ctx.saved_tensors
        # the backward reads dy (B, Ho, Wo, C) row-major; autograd may hand
        # back another layout (the expanded gradient of a ``.sum()``), so
        # it is copied to that one here, a no-op on the towers' path
        dy = dy.contiguous()
        if dy.device.type == "cpu":
            return pool_bwd(dy, idx, *ctx.hw)
        return cuda.launch_pool_bwd(dy, idx, *ctx.hw)

    @staticmethod
    def vmap(info, in_dims, x):
        seeds = info.batch_size
        x, c = fold_seeds_into_channels(x, in_dims[0], seeds)
        y, idx = _StoredIndexMaxPool.apply(x)
        return ((unfold_channels(y, seeds, c), unfold_channels(idx, seeds, c)),
                (3, 3))


def max_pool_3x3_s2_stored_index(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, ceil(H/2), ceil(W/2), C) max-pool, window 3,
    stride 2, pad 1.  Under autograd (grad enabled, ``x`` requiring grad,
    or batched by ``torch.func.vmap``, whose tensors do not report it) the
    forward and backward are the stored-index kernels, as the JAX op's
    ``custom_vjp``; elsewhere, as the JAX op's undifferentiated primal
    (XLA's ``reduce_window``), it is ``F.max_pool2d``, which needs no
    index."""
    if torch.is_grad_enabled() and (
            x.requires_grad or torch._C._functorch.is_batchedtensor(x)):
        return _StoredIndexMaxPool.apply(x)[0]
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
