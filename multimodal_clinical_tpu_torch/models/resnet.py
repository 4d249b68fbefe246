"""Scratch ResNet encoders (port of
``multimodal_clinical_tpu/models/resnet.py``): the BasicBlock ResNet18 and
the torchvision Bottleneck family (resnet152 for FakeNews).

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
port it selects the hand-written CUDA kernels.  Its two other switches:
``stem_space_to_depth`` (the stem as a 2x2 space-to-depth and a 4x4
stride-1 conv, the same function) and ``remat`` (block-level recompute,
``torch.utils.checkpoint`` in place of flax's ``nn.remat``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch._functorch.pyfunctorch import temporarily_pop_interpreter_stack
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from ..ops.maxpool import max_pool_3x3_s2_stored_index
from .common import (
    FusedBatchNorm, TorchBatchNorm, frozen_running_stats,
    kaiming_normal_fan_out_,
)

POOL_KERNELS = ("xla", "pallas")
# block-level recompute (the JAX ``_REMAT_POLICIES``): None saves every
# activation, "convs" saves the conv outputs only (BN apply and ReLU run
# again in the backward), "none" saves nothing inside a block
REMAT_POLICIES = (None, "convs", "none")
# the ops whose outputs "convs" saves: the JAX package tags conv1, conv2 and
# the projection conv ``conv_out``; F.conv2d reaches a selective
# checkpoint's policy as aten.convolution, on the CPU and on the card
SAVED_OPS = frozenset({torch.ops.aten.convolution.default})


def _bn(features: int, dtype: Optional[torch.dtype], fused: bool,
        scale_std: float = 0.02) -> nn.Module:
    return (FusedBatchNorm if fused else TorchBatchNorm)(features, dtype,
                                                         scale_std)


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
    dtype (flax ``StemConv``).  With ``space_to_depth`` the same function
    runs as the JAX module's rewrite: the input padded to 2 * out + 6 per
    spatial dim (3 on top/left), a 2x2 space-to-depth with the (s, t, c)
    channel packing, and the kernel zero-padded to 8x8 and regrouped to
    (width, 4 * C_in, 4, 4), applied stride 1 VALID.  The parameter stays
    the ordinary (width, C_in, 7, 7) ``weight``, so weights, checkpoints
    and OGM-GE's 4-D filter contract are the same either way."""

    def __init__(self, cin: int, width: int,
                 dtype: Optional[torch.dtype] = None,
                 space_to_depth: bool = False):
        super().__init__(cin, width, 7, 2, dtype)
        self.space_to_depth = space_to_depth

    def compute_dtype(self, x: torch.Tensor) -> torch.dtype:
        return self.dtype or x.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.space_to_depth:
            return super().forward(x)
        dtype = self.compute_dtype(x)
        b, c, h, w = x.shape
        h_out, w_out = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        # NHWC view of the channels_last map; pad 3 on top/left and the
        # rest of 2 * out + 6 on bottom/right
        xp = F.pad(x.to(dtype).permute(0, 2, 3, 1),
                   (0, 0, 3, 2 * w_out + 3 - w, 3, 2 * h_out + 3 - h))
        hz, wz = xp.shape[1] // 2, xp.shape[2] // 2
        z = xp.reshape(b, hz, 2, wz, 2, c).permute(0, 1, 3, 2, 4, 5)
        z = z.reshape(b, hz, wz, 4 * c).permute(0, 3, 1, 2)
        # (O, C, 8, 8) as (O, C, a', s, b', t) -> (O, (s, t, C), a', b')
        k8 = F.pad(self.weight.to(dtype), (0, 1, 0, 1))
        k = k8.reshape(-1, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
        k = k.reshape(-1, 4 * c, 4, 4)
        return F.conv2d(z, k.contiguous(memory_format=torch.channels_last))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False,
                 dtype: Optional[torch.dtype] = None, bn_fused: bool = False,
                 bn_scale_std: float = 0.02):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, stride, dtype)
        self.bn1 = _bn(planes, dtype, bn_fused, bn_scale_std)
        self.conv2 = Conv(planes, planes, 3, 1, dtype)
        self.bn2 = _bn(planes, dtype, bn_fused, bn_scale_std)
        self.downsample = (
            nn.Sequential(Conv(cin, planes, 1, stride, dtype),
                          _bn(planes, dtype, bn_fused, bn_scale_std))
            if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def _save_conv_outputs(ctx, op, *args, **kwargs):
    """The "convs" policy: keep the conv outputs, recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_contexts(remat: str):
    if remat == "convs":
        return create_selective_checkpoint_contexts(_save_conv_outputs)
    return contextlib.nullcontext(), contextlib.nullcontext()


class _ForwardThenRecompute:
    """What a block's checkpoint runs: the block's forward, and in the
    backward its recompute.  The BatchNorms move their running statistics
    in the forward only, as flax's functional ``nn.remat`` does."""

    def __init__(self, block: nn.Module, run=None):
        self.block, self.run, self.ran = block, run or block, False

    def __call__(self, *args: torch.Tensor) -> torch.Tensor:
        if not self.ran:
            self.ran = True
            return self.run(*args)
        with frozen_running_stats(self.block):
            return self.run(*args)


class ResNetEncoder(nn.Module):
    """Residual feature extractor: (B, H, W, C_in) -> stage-4 feature map
    (B, h, w, 8 * width), NHWC at both ends.  ``bn_scale_std`` 0 starts
    every BN scale at 1 (torchvision's init, the JAX ``bn_scale_init``
    of ``ResNet18Slim``).  ``remat`` (``REMAT_POLICIES``) runs each
    ``BasicBlock`` of a training pass under a non-reentrant
    ``torch.utils.checkpoint``; the stem, its BN and the pool stay outside
    it, and the ``state_dict`` is the same for every value."""

    def __init__(self, in_channels: int,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2), width: int = 64,
                 dtype: Optional[torch.dtype] = None,
                 stem_space_to_depth: bool = False, bn_fused: bool = False,
                 pool_kernel: str = "xla", bn_scale_std: float = 0.02,
                 remat: Optional[str] = None):
        super().__init__()
        if pool_kernel not in POOL_KERNELS:
            raise ValueError(f"pool_kernel must be one of {POOL_KERNELS}, "
                             f"got {pool_kernel!r}")
        if remat not in REMAT_POLICIES:
            raise ValueError(f"remat must be one of {REMAT_POLICIES}, got "
                             f"{remat!r}")
        self.pool_kernel = pool_kernel
        self.remat = remat
        self.conv1 = StemConv(in_channels, width, dtype, stem_space_to_depth)
        self.bn1 = _bn(width, dtype, bn_fused, bn_scale_std)
        planes, cin = width, width
        for stage, blocks in enumerate(stage_sizes):
            layer = []
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                # BasicBlock nets change width exactly when striding
                layer.append(BasicBlock(cin, planes, stride, stride != 1,
                                        dtype, bn_fused, bn_scale_std))
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
            for block in getattr(self, f"layer{stage + 1}"):
                x = self._block(block, x)
        return x.permute(0, 2, 3, 1)

    def _block(self, block: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.remat is None or not torch.is_grad_enabled():
            return block(x)
        if torch._C._functorch.is_batchedtensor(x):
            return _checkpoint_vmapped_block(block, x, self.remat)
        return checkpoint(_ForwardThenRecompute(block), x,
                          use_reentrant=False, preserve_rng_state=False,
                          context_fn=functools.partial(_remat_contexts,
                                                       self.remat))


def _checkpoint_vmapped_block(block: nn.Module, x: torch.Tensor,
                              remat: str) -> torch.Tensor:
    """A block under ``remat`` inside the multi-seed sweep's ``vmap``.  The
    checkpoint's recompute runs in the backward, outside that vmap, so the
    checkpoint is put outside it: the block's input, parameters and
    buffers are unwrapped to their stacked (S, ...) tensors, the
    checkpoint runs a vmap of the block over them (the recompute re-runs
    that vmap), and the output is wrapped back at the sweep's level."""
    level = torch._C._functorch.maybe_get_level(x)
    params = dict(block.named_parameters())
    buffers = dict(block.named_buffers())
    names = list(params) + list(buffers)
    stacked, dims = [], []
    for t in [x, *params.values(), *buffers.values()]:
        if (torch._C._functorch.is_batchedtensor(t)
                and torch._C._functorch.maybe_get_level(t) == level):
            t, bdim = torch._C._functorch._unwrap_batched(t, level)
        else:
            bdim = None
        stacked.append(t)
        dims.append(bdim)
    n_inputs = 1 + len(params)

    def one(x, *leaves):
        return torch.func.functional_call(
            block, (dict(zip(names[:len(params)], leaves[:len(params)])),
                    dict(zip(names[len(params):], leaves[len(params):]))),
            (x,))

    vmapped = torch.func.vmap(one, in_dims=tuple(dims))
    # the buffers reach the vmap from here, not as the checkpoint's
    # inputs: the forward moves the running statistics in place, which a
    # saved input may not see
    run = functools.partial(_with_buffers, vmapped, stacked[n_inputs:])
    # the checkpoint itself runs with the sweep's vmap level popped, as it
    # would outside the sweep: its tensors are the unwrapped ones
    with temporarily_pop_interpreter_stack():
        out = checkpoint(_ForwardThenRecompute(block, run),
                         *stacked[:n_inputs], use_reentrant=False,
                         preserve_rng_state=False,
                         context_fn=functools.partial(_remat_contexts, remat))
    return torch._C._functorch._add_batch_dim(out, 0, level)


def _with_buffers(vmapped, buffers, *inputs):
    return vmapped(*inputs, *buffers)


class BottleneckBlock(nn.Module):
    """torchvision Bottleneck (cremad/backbone.py:213-253): 1x1 -> 3x3
    (stride) -> 1x1 (4x), BN after each, a projection shortcut where
    ``downsample``.  BN scale starts at 1; ``bn_fused`` as in
    ``BasicBlock``."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False,
                 dtype: Optional[torch.dtype] = None, bn_fused: bool = False):
        super().__init__()
        self.conv1 = Conv(cin, planes, 1, 1, dtype)
        self.bn1 = _bn(planes, dtype, bn_fused, 0.0)
        self.conv2 = Conv(planes, planes, 3, stride, dtype)
        self.bn2 = _bn(planes, dtype, bn_fused, 0.0)
        self.conv3 = Conv(planes, 4 * planes, 1, 1, dtype)
        self.bn3 = _bn(4 * planes, dtype, bn_fused, 0.0)
        self.downsample = (
            nn.Sequential(Conv(cin, 4 * planes, 1, stride, dtype),
                          _bn(4 * planes, dtype, bn_fused, 0.0))
            if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class BottleneckResNetEncoder(nn.Module):
    """Bottleneck residual encoder (resnet50/101/152), NHWC at both ends:
    (B, H, W, C_in) -> (B, h, w, 32 * width).  torchvision's names
    (``conv1``, ``bn1``, ``layer{s}.{b}.conv{1,2,3}``, ``bn{1,2,3}``,
    ``downsample.{0,1}``), so a torchvision state_dict loads as it is;
    the projection sits on the first block of every stage, stage 0
    included (the 4x channel expansion).  ``bn_fused=True`` puts
    ``FusedBatchNorm`` in place of every BN, the stem's included."""

    def __init__(self, in_channels: int = 3,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 dtype: Optional[torch.dtype] = None, bn_fused: bool = False):
        super().__init__()
        self.conv1 = StemConv(in_channels, width, dtype)
        self.bn1 = _bn(width, dtype, bn_fused, 0.0)
        planes, cin = width, width
        for stage, blocks in enumerate(stage_sizes):
            layer = []
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                layer.append(BottleneckBlock(cin, planes, stride, b == 0,
                                             dtype, bn_fused))
                cin = 4 * planes
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))
            planes *= 2
        self.stage_sizes = tuple(stage_sizes)
        self.out_features = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view: channels_last
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for stage in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.permute(0, 2, 3, 1)


def resnet152_encoder(in_channels: int = 3,
                      dtype: Optional[torch.dtype] = None
                      ) -> BottleneckResNetEncoder:
    """torchvision resnet152's geometry, the FakeNews embed image tower
    (fakenews/model.py:238)."""
    return BottleneckResNetEncoder(in_channels, (3, 8, 36, 3), dtype=dtype)
