"""CUDA 3x3 SAME convolution (``csrc/conv3x3.cu``) and its wrapper.

Port of ``tools/proto_pallas_conv.py::conv_pallas``: an implicit GEMM on
the bf16 tensor cores (``wgmma`` from shared memory, fed through an
``mbarrier`` ring by a producer warpgroup: the weights by TMA, the im2col
tile by TMA at Cin a multiple of 64 and by a ``cp.async`` gather
otherwise), fp32 accumulation, one rounding to bf16, the halo masked in
the kernel.  It takes the JAX layouts: x
(B, H, W, Cin) contiguous, the NHWC view of a channels_last map, and w
(3, 3, Cin, Cout) HWIO contiguous.  The kernel source says what bounds it
and how its design answers.  The plain version is
``ops/conv3x3.conv3x3``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("conv3x3")
    lib.mmct_conv3x3.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x, w, y
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, H, W
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,         # Cin, Cout, stream
    ]
    lib.mmct_conv3x3.restype = ctypes.c_int
    lib.mmct_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mmct_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y (B, H, W, Cout) bf16 = SAME 3x3 stride-1 conv of x (B, H, W, Cin)
    with w (3, 3, Cin, Cout), both bf16, contiguous, 16-byte aligned, on
    one card, Cin and Cout multiples of 16.  Raises on anything else."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"need bfloat16 x and w, got {x.dtype} and "
                         f"{w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (
            3, 3, x.shape[-1]):
        raise ValueError(f"need x (B, H, W, Cin) and w (3, 3, Cin, Cout); "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    if cin % 16 or cout % 16 or x.numel() == 0 or w.numel() == 0:
        raise ValueError(f"Cin and Cout must be multiples of 16 and the "
                         f"tensors non-empty; got x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous tensor (x the NHWC "
                             f"view of a channels_last map, w HWIO); got "
                             f"strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data is not 16-byte aligned")
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"the CUDA conv kernel needs x and w as CUDA tensors "
                         f"on one card; they are on {x.device} and "
                         f"{w.device}")
    y = torch.empty(b, h, wd, cout, dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmct_conv3x3(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h,
                               wd, cin, cout, stream)
    if err != 0:
        raise RuntimeError("conv3x3 kernel launch failed: "
                           + lib.mmct_cuda_error_string(err).decode())
    launch_conv3x3.launches += 1
    return y


launch_conv3x3.launches = 0
