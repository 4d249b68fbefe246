"""The 3x3 / stride-1 SAME conv kernel against cuDNN, per ResNet geometry.

Port of ``tools/proto_pallas_conv.py``.  ``conv_pallas`` is the CUDA
kernel (``ops/cuda_conv3x3.py``: an implicit GEMM on the bf16 tensor
cores, the halo masked in the kernel) for a CUDA tensor and its plain
version (``ops/conv3x3.py``) for a CPU tensor; ``conv_xla`` is the library
column, ``F.conv2d`` on the channels_last map (cuDNN on a card).  ``main``
keeps the TPU probe's geometries, draws and printed line; TF/s is against
the card's bf16 dense tensor-core peak.

    python -m multimodal_clinical_tpu_torch.tools.proto_pallas_conv [--check] [--iters 20]

Needs a card: ``main`` raises without CUDA.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cuda_conv3x3
from ..ops.conv3x3 import conv3x3
from ..utils.device import resolve_device

# H100 SXM bf16 dense tensor-core peak (NVIDIA data sheet, 700 W)
PEAK_TFLOPS = 989.0


def conv_pallas(x: torch.Tensor, w: torch.Tensor, nb=None) -> torch.Tensor:
    """SAME 3x3 conv of x (B, H, W, Cin) with w (3, 3, Cin, Cout) HWIO, fp32
    accumulation, output (B, H, W, Cout) in x's dtype: the kernel for a
    CUDA tensor, the plain version for a CPU one.  ``nb`` (the TPU kernel's
    images per grid step) is ignored."""
    if x.device.type == "cpu":
        return conv3x3(x, w)
    return cuda_conv3x3.launch_conv3x3(x, w)


def conv_xla(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same conv by the library: ``F.conv2d`` on the channels_last view
    of x, returned as a contiguous NHWC tensor in x's dtype.  On the CPU it
    computes in fp32 from x's values and rounds once (PyTorch's CPU bf16
    convolution returned NaN at a tiny shape)."""
    xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    if x.device.type == "cpu":
        y = F.conv2d(xc.float(), wc.float(), padding=1).to(x.dtype)
    else:
        y = F.conv2d(xc, wc, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


GEOMS = [  # name, B, H, W, Cin, Cout, images/step (the TPU kernel's nb)
    ("vis_l1", 896, 56, 56, 64, 64, 1),
    ("vis_l2", 896, 28, 28, 128, 128, 4),
    ("vis_l3", 896, 14, 14, 256, 256, 8),
    ("vis_l4", 896, 7, 7, 512, 512, 16),
    ("aud_l1", 224, 33, 157, 64, 64, 1),
    ("aud_l2", 224, 17, 79, 128, 128, 2),
    ("aud_l3", 224, 9, 40, 256, 256, 8),
    ("aud_l4", 224, 5, 20, 512, 512, 16),
]


def timeit(fn, args, iters):
    """Seconds per call, host clock between two synchronisations."""
    fn(*args)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - tic) / iters


def main(check: bool = False, iters: int = 20) -> None:
    """Prints, per geometry, the kernel's error against cuDNN (``check``)
    or both times."""
    device = resolve_device("cuda")
    rng = np.random.default_rng(0)
    for name, b, h, wd, cin, cout, nb in GEOMS:
        while b % nb:
            nb //= 2
        x = torch.from_numpy(rng.normal(size=(b, h, wd, cin)).astype(
            np.float32)).to(torch.bfloat16).to(device)
        w = torch.from_numpy(rng.normal(size=(3, 3, cin, cout)).astype(
            np.float32) * 0.05).to(torch.bfloat16).to(device)
        flops = 2 * b * h * wd * cout * cin * 9
        if check:
            yp = conv_pallas(x, w, nb).float()
            yx = conv_xla(x, w).float()
            err = float((yp - yx).abs().max() / (yx.abs().max() + 1e-6))
            print(f"{name}: rel err {err:.2e}")
            continue
        t_p = timeit(lambda x, w: conv_pallas(x, w, nb), (x, w), iters)
        t_x = timeit(conv_xla, (x, w), iters)
        print(f"{name:8s} nb={nb:<3d} pallas {t_p * 1e3:8.4f} ms "
              f"({flops / t_p / 1e12:6.1f} TF/s "
              f"{flops / t_p / 1e12 / PEAK_TFLOPS * 100:5.1f}%)  "
              f"xla {t_x * 1e3:8.4f} ms ({flops / t_x / 1e12:6.1f} TF/s)  "
              f"speedup {t_x / t_p:5.2f}x", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args()
    main(a.check, a.iters)
