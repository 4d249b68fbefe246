"""CUDA one-pass BN statistics (``csrc/bn_stats.cu``) and its wrapper.

Port of ``tools/proto_bn_stats.py::pallas_bn_stats``: per-channel mean and
biased variance of a channels-last (..., C) map, read in place as (M, C),
in one launch (the last block of each group of 64 channels to finish folds
that group's partial sums).
Two launches on one input agree bit for bit.  The kernel source says what
bounds it and how its design answers.  The plain version is
``ops/bn_stats.bn_stats``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ..kernels import build

DTYPES = (torch.bfloat16, torch.float32)
# the ticket counters (one per channel group) of each (device, stream):
# zeroed once, then set back to 0 by the last blocks of every launch
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("bn_stats")
    lib.mmct_bn_stats_blocks.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.mmct_bn_stats_blocks.restype = ctypes.c_int
    lib.mmct_bn_stats_groups.argtypes = [ctypes.c_int]
    lib.mmct_bn_stats_groups.restype = ctypes.c_int
    lib.mmct_bn_stats_max_groups.argtypes = []
    lib.mmct_bn_stats_max_groups.restype = ctypes.c_int
    lib.mmct_bn_stats.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,  # x, bf16, M, C
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,              # partial, blocks, counters
        ctypes.c_void_p, ctypes.c_void_p,                            # out, stream
    ]
    lib.mmct_bn_stats.restype = ctypes.c_int
    lib.mmct_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mmct_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _counters(lib, device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(lib.mmct_bn_stats_max_groups(),
                                     dtype=torch.int32, device=device)
    return _COUNTERS[key]


def launch_bn_stats(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased var) per channel, fp32 (C,) each, of a contiguous
    (..., C) bf16 or fp32 CUDA tensor (the NHWC view of a channels_last
    map), C a multiple of 8 up to 2048.  Raises on anything the kernel does
    not take."""
    if t.dtype not in DTYPES:
        raise ValueError(f"t: need bfloat16 or float32, got {t.dtype}")
    if t.dim() < 2 or not t.is_contiguous() or t.numel() == 0:
        raise ValueError(f"t: need a non-empty contiguous (..., C) tensor, "
                         f"the NHWC view of a channels_last map; got shape "
                         f"{tuple(t.shape)}, strides {t.stride()}")
    c = t.shape[-1]
    if c % 8 or c > 2048:
        raise ValueError(f"t: C must be a multiple of 8 up to 2048, got {c}")
    if t.data_ptr() % 16:
        raise ValueError("t: data is not 16-byte aligned")
    if not t.is_cuda:
        raise ValueError(f"the CUDA BN-stats kernel needs a CUDA tensor; t is "
                         f"on {t.device}")
    m = t.numel() // c
    lib = _lib()
    blocks = lib.mmct_bn_stats_blocks(m, c)
    partial = torch.empty(lib.mmct_bn_stats_groups(c), blocks, 2, 64,
                          dtype=torch.float32, device=t.device)
    out = torch.empty(2, c, dtype=torch.float32, device=t.device)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmct_bn_stats(t.data_ptr(), int(t.dtype == torch.bfloat16),
                                m, c, partial.data_ptr(), blocks,
                                _counters(lib, t.device, stream).data_ptr(),
                                out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("bn_stats kernel launch failed: "
                           + lib.mmct_cuda_error_string(err).decode())
    launch_bn_stats.launches += 1
    return out[0], out[1]


launch_bn_stats.launches = 0
