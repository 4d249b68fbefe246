"""3x3, stride-1, SAME convolution: the plain version of kernel
``ops/cuda_conv3x3.launch_conv3x3`` (``csrc/conv3x3.cu``), the port of
``tools/proto_pallas_conv.py::conv_pallas``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, Cin), w (3, 3, Cin, Cout) HWIO -> (B, H, W, Cout) in
    x's dtype: the TPU kernel's ``_tap_kernel`` formula.  Pads x by one
    pixel, then sums the nine shifted (B H W, Cin) @ (Cin, Cout) products
    in tap order, each fp32 from the input values (exact for bf16), and
    rounds once.  On a card it wants ``allow_tf32`` off, as every fp32
    reference here does."""
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = w.reshape(9, cin, cout).float()
    acc = None
    for t in range(9):
        ky, kx = divmod(t, 3)
        rows = xp[:, ky:ky + h, kx:kx + wd, :].reshape(-1, cin).float()
        prod = rows @ taps[t]
        acc = prod if acc is None else acc.add_(prod)
    return acc.reshape(b, h, wd, cout).to(x.dtype)
