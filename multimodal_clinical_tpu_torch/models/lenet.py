"""LeNet encoder for AV-MNIST (port of
``multimodal_clinical_tpu/models/lenet.py``; reference
avmnist/joint_model.py:32-97).

A 5x5 conv (pad 2) followed by ``additional_layers`` 3x3 convs (pad 1),
channels doubling each block; each block is conv (no bias) -> BN -> ReLU
-> 2x2 max-pool, and a global average pool ends the tower.  Module names
are the reference's ``convs.N`` / ``bns.N``, so the JAX package's
``port_lenet`` reads the state_dict as it is.  Convs are kaiming-uniform
(avmnist/joint_model.py:69-71); the BN scale starts at 1 (flax's
``TorchBatchNorm`` default).  NHWC in; inside, the NCHW view of it is
``channels_last``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import TorchBatchNorm, global_avg_pool, kaiming_uniform_, max_pool
from .resnet import Conv


class LeNetConv(Conv):
    """Bias-free conv, padding k // 2 (5x5 SAME, 3x3 pad 1), kaiming-uniform
    init."""

    def reset_parameters(self, generator=None):
        kaiming_uniform_(self.weight, generator)


class LeNet(nn.Module):
    """(B, H, W, in_channels) -> (B, channels * 2 ** additional_layers)."""

    def __init__(self, in_channels: int = 1, channels: int = 6,
                 additional_layers: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        convs, bns = [], []
        cin = in_channels
        for i in range(additional_layers + 1):
            cout = channels * 2 ** i
            convs.append(LeNetConv(cin, cout, 5 if i == 0 else 3,
                                   dtype=dtype))
            bns.append(TorchBatchNorm(cout, dtype, scale_std=0.0))
            cin = cout
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)
        self.out_features = cin
        self.flax_names = {
            **{f"convs.{i}": f"Conv_{i}" for i in range(len(convs))},
            **{f"bns.{i}": f"TorchBatchNorm_{i}" for i in range(len(bns))}}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view: channels_last
        for conv, bn in zip(self.convs, self.bns):
            x = max_pool(F.relu(bn(conv(x))), 2)
        return global_avg_pool(x.permute(0, 2, 3, 1))
