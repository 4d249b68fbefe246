"""Probe: does a copy kernel over the (H, W, C, N)-permuted view of a conv
output cost more than one over the map itself?

Port of ``tools/probe_pallas_layout.py``.  On the TPU the question was
whether the transposed view lowers to a bitcast or forces relayout copies.
On the card a permute is a view, and the copy kernel
(``ops/cuda_identity.py``) moves a dense tensor in its storage order
whatever its strides, so B should cost what C costs.  Three programs on the
visual stem's geometry:

  A) conv -> relu -> maxpool                                  (baseline)
  B) conv -> relu -> permute -> identity copy -> permute back -> maxpool
  C) conv -> relu -> identity copy (NHWC direct) -> maxpool

each ending in an fp32 sum.  The copy moves 2x the map (read + write,
2.9 GB in bf16 at the default geometry).

    python -m multimodal_clinical_tpu_torch.tools.probe_pallas_layout

Needs a card: ``main`` raises without CUDA; ``build`` takes
``device="cpu"`` and a smaller geometry, where the copy is the plain
version.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cuda_identity
from ..ops.identity import identity
from ..utils.device import resolve_device
from .proto_pallas_conv import conv_xla

# (N, H, W, Cin, Cout): the TPU probe's visual stem, conv output
# (896, 112, 112, 64)
GEOM = (896, 112, 112, 3, 64)


def pallas_identity(x: torch.Tensor, split: int = 4) -> torch.Tensor:
    """A copy of a dense ``x`` with its strides: the kernel for a CUDA
    tensor, the plain version for a CPU one.  ``split`` (the TPU kernel's
    blocks along dim 1) is ignored."""
    if x.device.type == "cpu":
        return identity(x)
    return cuda_identity.launch_identity(x)


def build(variant: str, geom=GEOM, device="cuda"):
    """(fn, x, w) as the TPU probe's ``build``: x (N, H, W, Cin) bf16 and
    w (3, 3, Cin, Cout) HWIO bf16 from its draws."""
    device = resolve_device(device)
    n, h, w, cin, cout = geom
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(n, h, w, cin))).to(
        torch.bfloat16).to(device)
    k = torch.from_numpy(rng.normal(size=(3, 3, cin, cout)) * 0.1).to(
        torch.bfloat16).to(device)

    def fn(x, w):
        t = torch.relu(conv_xla(x, w))  # NHWC view of a channels_last map
        if variant == "B":
            tt = t.permute(1, 2, 3, 0)  # (H, W, C, N), a view
            tt = pallas_identity(tt)
            t = tt.permute(3, 0, 1, 2)
        elif variant == "C":
            t = pallas_identity(t)
        y = F.max_pool2d(t.permute(0, 3, 1, 2), 3, 2, 1)
        return y.float().sum()

    return fn, x, k


def main(iters: int = 10) -> None:
    """Prints the ms per call of each variant."""
    resolve_device("cuda")
    for variant in ("A", "B", "C"):
        f, x, w = build(variant)
        float(f(x, w))
        float(f(x, w))
        tic = time.perf_counter()
        for _ in range(iters):
            out = f(x, w)
        float(out)
        dt = (time.perf_counter() - tic) / iters
        print(f"variant {variant}: {dt * 1e3:8.4f} ms", flush=True)
        del f, x, w, out


if __name__ == "__main__":
    main()
