"""One-pass BN statistics in context: conv -> stats -> scale, shift, ReLU ->
sum, with the stats by the kernel or by the plain formula.

Port of ``tools/proto_bn_stats.py``, at its geometries and with its draws:

  "xla":     mean = mean(x), var = mean(x * x) - mean^2   (flax BN's math)
  "pallas":  ``pallas_bn_stats``, the one-launch CUDA kernel
             (``ops/cuda_bn_stats.py``) for a CUDA map

and the TPU probe's check that the two agree.  The kernel reads the
channels_last conv output in place; the TPU probe's (H, W, C, N) bitcast
view is a batch-minor layout trick that does not carry over.

    python -m multimodal_clinical_tpu_torch.tools.proto_bn_stats

Needs a card: ``main`` raises without CUDA; ``build`` takes
``device="cpu"``, where the stats are the plain version.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import cuda_bn_stats
from ..ops.bn_stats import bn_stats
from ..utils.device import resolve_device
from .proto_pallas_conv import conv_xla

GEOMS = {
    # batch 224, 4 frames -> N = 896 visual; audio tower N = 224,
    # (33, 157) after the stem and its max-pool
    "visual_stage1": (896, 56, 56, 64, 64),
    "visual_stage2": (896, 28, 28, 128, 128),
    "audio_stage1": (224, 33, 157, 64, 64),
}


def pallas_bn_stats(t_nhwc: torch.Tensor, wblk: int = 8):
    """(N, H, W, C) feature map (contiguous: the NHWC view of a
    channels_last map) -> fp32 per-channel (mean, var), in one pass: the
    kernel for a CUDA map, the plain version for a CPU one.  ``wblk`` (the
    TPU kernel's block width) is ignored."""
    if t_nhwc.device.type == "cpu":
        return bn_stats(t_nhwc)
    return cuda_bn_stats.launch_bn_stats(t_nhwc)


def operands(geom, device="cuda"):
    """The TPU probe's draws, in its order and layouts: x (N, H, W, Cin)
    bf16, k (3, 3, Cin, Cout) HWIO bf16, gamma and beta (Cout,) fp32."""
    device = resolve_device(device)
    n, h, w, cin, cout = geom
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(n, h, w, cin))).to(torch.bfloat16)
    k = torch.from_numpy(rng.normal(size=(3, 3, cin, cout)) * 0.1).to(
        torch.bfloat16)
    gamma = torch.from_numpy(rng.normal(size=(cout,)) * 0.1 + 1.0).float()
    beta = torch.from_numpy(rng.normal(size=(cout,)) * 0.1).float()
    return tuple(a.to(device) for a in (x, k, gamma, beta))


def step(variant: str):
    """fn(x, k, gamma, beta) -> (sum of the normalised ReLU map, mean,
    var), the stats by ``variant``."""

    def fn(x, k, gamma, beta):
        t = conv_xla(x, k)  # bf16, NHWC view of a channels_last map
        if variant == "pallas":
            mean, var = pallas_bn_stats(t)
        else:  # flax BatchNorm's stats math (mean + mean-of-squares)
            tf = t.float()
            mean = tf.mean(dim=(0, 1, 2))
            mu2 = (tf * tf).mean(dim=(0, 1, 2))
            var = mu2 - mean * mean
        inv = gamma * torch.rsqrt(var + 1e-5)
        y = torch.relu((t.float() - mean) * inv + beta)
        return y.sum(), mean, var

    return fn


def build(variant: str, geom, device="cuda"):
    """(fn, args) as the TPU probe's ``build``."""
    return step(variant), operands(geom, device)


def timed(fn, args, iters=20):
    """(ms per call, last output), host clock between synchronisations."""
    out = fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3, out


def main(iters: int = 20) -> None:
    """Both variants per geometry, held together as the TPU probe holds
    them; prints both times."""
    device = resolve_device("cuda")
    for name, geom in GEOMS.items():
        args = operands(geom, device)
        ms_a, out_a = timed(step("xla"), args, iters)
        ms_b, out_b = timed(step("pallas"), args, iters)
        np.testing.assert_allclose(out_b[1].cpu().numpy(),
                                   out_a[1].cpu().numpy(),
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(out_b[2].cpu().numpy(),
                                   out_a[2].cpu().numpy(),
                                   rtol=2e-2, atol=2e-2)
        print(f"{name}: xla {ms_a:.4f} ms  pallas {ms_b:.4f} ms  "
              f"({'pallas wins' if ms_b < ms_a else 'xla wins'}, "
              f"{ms_b / ms_a:.2f}x)", flush=True)
        del args, out_a, out_b


if __name__ == "__main__":
    main()
