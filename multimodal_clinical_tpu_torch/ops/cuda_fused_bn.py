"""CUDA batch-norm sums (``csrc/bn_sums.cu``) and their wrappers.

Port of the two Pallas kernels of ``multimodal_clinical_tpu/ops/fused_bn.py``:
``launch_channel_sums`` replaces ``_channel_sums_pallas`` (per-channel sum
and sum of squares) and ``launch_bwd_sums`` replaces ``_bwd_sums_pallas``
(sum of dy and of dy * xhat).  Both take the JAX layout, channels last:
a tensor (..., C) that is contiguous, i.e. the NHWC view of a
``channels_last`` feature map, read as (M, C).  Sums are fp32, from bf16
or fp32 inputs; two launches on one input agree bit for bit.  The forward
is one launch: its partial sums and ticket counters are scratch kept per
(device, stream), so a call allocates only its (2, C) output.  The kernel
source says what bounds it and how its design answers.  The plain
versions are ``ops/fused_bn.channel_sums`` and ``bwd_sums``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ..kernels import build

DTYPES = (torch.bfloat16, torch.float32)
# The forward's grid (csrc/bn_sums.cu): (row blocks, channel groups of
# GROUP_C); a block of THREADS threads, each keeping 256 bytes of rows in
# flight; BLOCKS_PER_SM blocks per SM in all, fewer where M is short.
GROUP_C, THREADS, BLOCKS_PER_SM, MAX_C = 64, 256, 2, 2048
# the forward's scratch of each (device, stream): the blocks' partial sums
# (2 * GROUP_C floats a block, as many blocks as the largest grid on that
# device), the ticket counters (one per group, zeroed once and set back to
# 0 by the last blocks of every launch), and the device's SM count
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor, int]] = {}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("bn_sums")
    lib.mmct_bn_sums_blocks.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.mmct_bn_sums_blocks.restype = ctypes.c_int
    lib.mmct_bn_sums.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,  # x, bf16, M, C
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,               # row blocks, scratch, floats
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,           # counters, out, stream
    ]
    lib.mmct_bn_sums.restype = ctypes.c_int
    lib.mmct_bn_bwd_sums.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,               # dy, x, bf16
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,  # mean, rstd, M, C
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,               # partial, blocks, out
        ctypes.c_void_p,                                              # stream
    ]
    lib.mmct_bn_bwd_sums.restype = ctypes.c_int
    lib.mmct_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mmct_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_feature_map(t: torch.Tensor, what: str) -> Tuple[int, int]:
    """(M, C) of a channels-last tensor the kernels take; raises otherwise."""
    if not t.is_cuda:
        raise ValueError(f"the CUDA BN-sums kernels need a CUDA tensor; {what} "
                         f"is on {t.device}")
    if t.dtype not in DTYPES:
        raise ValueError(f"{what}: need bfloat16 or float32, got {t.dtype}")
    if t.dim() < 2 or not t.is_contiguous():
        raise ValueError(f"{what}: need a contiguous (..., C) tensor, the "
                         f"NHWC view of a channels_last map; got shape "
                         f"{tuple(t.shape)}, strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: data is not 16-byte aligned")
    c = t.shape[-1]
    return t.numel() // max(c, 1), c


def _blocks(lib, m: int, c: int) -> int:
    blocks = lib.mmct_bn_sums_blocks(m, c)
    if blocks <= 0:
        raise ValueError(f"unsupported (M, C) = ({m}, {c}): need M > 0 and C "
                         f"a multiple of 8 up to 2048")
    return blocks


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.mmct_cuda_error_string(err).decode())


def fwd_row_blocks(m: int, c: int, sms: int, bf16: bool = True) -> int:
    """Row blocks per channel group of the forward's grid on a card with
    ``sms`` SMs: BLOCKS_PER_SM * sms blocks in all (at least one per
    group), but no more than give each thread one full step of loads (16
    rows of bf16, 8 of fp32)."""
    groups = -(-c // GROUP_C)
    lanes = THREADS // (min(c, GROUP_C) // 8)
    want = -(-m // (lanes * (16 if bf16 else 8)))
    return min(want, max(sms * BLOCKS_PER_SM // groups, 1))


def fwd_slabs(m: int, row_blocks: int):
    """[first, end) rows of each row block of the forward, in block order:
    ceil(m / row_blocks) rows each, the last ones short or empty."""
    per = -(-m // row_blocks)
    return [(min(i * per, m), min(i * per + per, m))
            for i in range(row_blocks)]


def _scratch(device: torch.device,
             stream: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The forward's (partial sums, counters, SM count) of ``stream``, made
    on first use; ``device`` is the current device."""
    key = (device.index, stream)
    if key not in _SCRATCH:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        groups = MAX_C // GROUP_C
        blocks = max(sms * BLOCKS_PER_SM, groups)
        _SCRATCH[key] = (
            torch.empty(blocks * 2 * GROUP_C, dtype=torch.float32,
                        device=device),
            torch.zeros(groups, dtype=torch.int32, device=device), sms)
    return _SCRATCH[key]


def launch_channel_sums(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum x, sum x^2) per channel, fp32 (C,) each, of a contiguous
    (..., C) CUDA tensor, in one kernel launch; raises on anything the
    kernel does not take."""
    m, c = _check_feature_map(x, "x")
    lib = _lib()
    _blocks(lib, m, c)  # raises on a shape the kernels do not take
    out = torch.empty(2, c, dtype=torch.float32, device=x.device)
    bf16 = x.dtype == torch.bfloat16
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        scratch, counters, sms = _scratch(x.device, stream)
        err = lib.mmct_bn_sums(x.data_ptr(), int(bf16), m, c,
                               fwd_row_blocks(m, c, sms, bf16),
                               scratch.data_ptr(), scratch.numel(),
                               counters.data_ptr(), out.data_ptr(), stream)
    _raise_on(lib, err, "bn_sums")
    launch_channel_sums.launches += 1
    return out.unbind(0)


launch_channel_sums.launches = 0


def launch_bwd_sums(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                    rstd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum dy, sum dy * (x - mean) * rstd) per channel, fp32 (C,) each;
    dy and x contiguous (..., C) CUDA tensors of one shape and dtype,
    mean and rstd (C,) fp32.  Raises on anything the kernel does not take."""
    m, c = _check_feature_map(x, "x")
    _check_feature_map(dy, "dy")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    for name, v in (("mean", mean), ("rstd", rstd)):
        if (v.device != x.device or v.dtype != torch.float32
                or v.shape != (c,) or not v.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous ({c},) float32 "
                             f"tensor on {x.device}")
    lib = _lib()
    blocks = _blocks(lib, m, c)
    partial = torch.empty(blocks, 2, c, dtype=torch.float32, device=x.device)
    out = torch.empty(2, c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmct_bn_bwd_sums(
            dy.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16),
            mean.data_ptr(), rstd.data_ptr(), m, c, partial.data_ptr(),
            blocks, out.data_ptr(), stream)
    _raise_on(lib, err, "bn_bwd_sums")
    launch_bwd_sums.launches += 1
    return out[0], out[1]


launch_bwd_sums.launches = 0
