"""CUDA identity copy (``csrc/identity_copy.cu``) and its wrapper.

Port of ``tools/probe_pallas_layout.py::pallas_identity``: a copy of a
dense tensor in its storage order, whatever its strides, so the
(H, W, C, N) permuted view of an NHWC map costs what the map costs.  The
kernel source says what bounds it and how its design answers.  The plain
version is ``ops/identity.identity``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("identity_copy")
    lib.mmct_identity_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int64, ctypes.c_void_p]
    lib.mmct_identity_copy.restype = ctypes.c_int
    lib.mmct_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mmct_cuda_error_string.restype = ctypes.c_char_p
    return lib


def is_dense(t: torch.Tensor) -> bool:
    """True when ``t``'s elements fill one span of memory with no gap and
    no overlap, in some order of its dims."""
    expected = 1
    for stride, size in sorted((s, n) for s, n in zip(t.stride(), t.shape)
                               if n != 1):
        if stride != expected:
            return False
        expected *= size
    return True


def launch_identity(x: torch.Tensor) -> torch.Tensor:
    """A copy of a dense, non-overlapping, 16-byte aligned CUDA tensor, in
    ``torch.empty_like(x)`` (the same strides).  Raises on anything the
    kernel does not take."""
    if x.numel() == 0 or not is_dense(x):
        raise ValueError(f"need a non-empty dense, non-overlapping tensor; "
                         f"got shape {tuple(x.shape)}, strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError("x: data is not 16-byte aligned")
    if not x.is_cuda:
        raise ValueError(f"the CUDA copy kernel needs a CUDA tensor; x is on "
                         f"{x.device}")
    out = torch.empty_like(x)
    if out.stride() != x.stride():
        raise ValueError(f"empty_like gave strides {out.stride()} for "
                         f"{x.stride()}")
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmct_identity_copy(x.data_ptr(), out.data_ptr(),
                                     x.numel() * x.element_size(), stream)
    if err != 0:
        raise RuntimeError("identity_copy kernel launch failed: "
                           + lib.mmct_cuda_error_string(err).decode())
    launch_identity.launches += 1
    return out


launch_identity.launches = 0
