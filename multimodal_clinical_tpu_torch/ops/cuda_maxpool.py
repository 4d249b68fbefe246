"""CUDA stored-index max-pool (``csrc/maxpool.cu``) and its wrappers.

Port of the two Pallas kernels of
``multimodal_clinical_tpu/ops/maxpool_pallas.py``: ``launch_pool_fwd``
replaces ``_pool_fwd_pallas`` (3x3 / stride 2 / pad 1 max and the tap
index 0..8 of the first maximum) and ``launch_pool_bwd`` replaces
``_pool_bwd_pallas`` (dy routed to dx through that index).  Both take the
JAX layout, (B, H, W, C) and contiguous: the NHWC view of a
``channels_last`` map.  The index is uint8.  The kernel source says what
bounds it and how its design answers.  The plain versions are
``ops/maxpool.pool_fwd`` and ``pool_bwd``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..kernels import build

DTYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("maxpool")
    args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # in, in/out, out
            ctypes.c_int, ctypes.c_int, ctypes.c_int,             # bf16, B, H
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]          # W, C, stream
    for fn in (lib.mmct_maxpool_fwd, lib.mmct_maxpool_bwd):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.mmct_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mmct_cuda_error_string.restype = ctypes.c_char_p
    return lib


def pooled_size(n: int) -> int:
    """Output extent of a 3 / 2 / 1 pool over an input extent ``n``."""
    return (n - 1) // 2 + 1


def _check(t: torch.Tensor, what: str, dtypes=DTYPES) -> None:
    if not t.is_cuda:
        raise ValueError(f"the CUDA max-pool kernels need a CUDA tensor; "
                         f"{what} is on {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{what}: unsupported dtype {t.dtype}")
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"{what}: need a contiguous (B, H, W, C) tensor, the "
                         f"NHWC view of a channels_last map; got shape "
                         f"{tuple(t.shape)}, strides {t.stride()}")
    if t.shape[-1] % 8 or t.numel() == 0:
        raise ValueError(f"{what}: C must be a multiple of 8 and the tensor "
                         f"non-empty, got shape {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: data is not 16-byte aligned")


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.mmct_cuda_error_string(err).decode())


def launch_pool_fwd(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, idx) of a contiguous (B, H, W, C) CUDA tensor: y in x's dtype,
    idx uint8, both (B, ceil(H/2), ceil(W/2), C).  Raises on anything the
    kernel does not take."""
    _check(x, "x")
    b, h, w, c = x.shape
    shape = (b, pooled_size(h), pooled_size(w), c)
    y = torch.empty(shape, dtype=x.dtype, device=x.device)
    idx = torch.empty(shape, dtype=torch.uint8, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmct_maxpool_fwd(x.data_ptr(), y.data_ptr(), idx.data_ptr(),
                                   int(x.dtype == torch.bfloat16), b, h, w, c,
                                   stream)
    _raise_on(lib, err, "maxpool_fwd")
    launch_pool_fwd.launches += 1
    return y, idx


launch_pool_fwd.launches = 0


def launch_pool_bwd(dy: torch.Tensor, idx: torch.Tensor, h: int,
                    w: int) -> torch.Tensor:
    """dx (B, h, w, C) in dy's dtype: dy routed through the uint8 ``idx``
    of ``launch_pool_fwd``.  Raises on anything the kernel does not take."""
    _check(dy, "dy")
    _check(idx, "idx", (torch.uint8,))
    b, ho, wo, c = dy.shape
    if idx.shape != dy.shape or idx.device != dy.device or (ho, wo) != (
            pooled_size(h), pooled_size(w)):
        raise ValueError(f"dy {tuple(dy.shape)} and idx {tuple(idx.shape)} "
                         f"do not pool an input of {h} x {w}")
    dx = torch.empty(b, h, w, c, dtype=dy.dtype, device=dy.device)
    lib = _lib()
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmct_maxpool_bwd(dy.data_ptr(), idx.data_ptr(),
                                   dx.data_ptr(),
                                   int(dy.dtype == torch.bfloat16), b, h, w,
                                   c, stream)
    _raise_on(lib, err, "maxpool_bwd")
    launch_pool_bwd.launches += 1
    return dx


launch_pool_bwd.launches = 0
