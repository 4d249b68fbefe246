"""CUDA log-spectrogram kernel (``csrc/log_spectrogram.cu``) and its wrapper.

Port of ``multimodal_clinical_tpu/ops/pallas_spectrogram.py``: the same
function as ``pallas_log_spectrogram`` — centred Hann STFT, log(|X| + eps),
(B, N) fp32 -> (B, n_fft//2 + 1, T) fp32 — for any hop, not only
hop == n_fft / 2.  The kernel's source note says what bounds it and how its
design answers.  ``ops/spectrogram.log_spectrogram`` is its plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import build
from . import spectrogram as plain


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("log_spectrogram")
    lib.mmct_log_spectrogram.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # wave, table, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, N, n_fft, hop
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # bins, bins_pad, T
        ctypes.c_float, ctypes.c_void_p,                     # eps, stream
    ]
    lib.mmct_log_spectrogram.restype = ctypes.c_int
    lib.mmct_log_spectrogram_freq_tile.restype = ctypes.c_int
    lib.mmct_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mmct_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=8)
def _device_table(n_fft: int, n_bins_pad: int,
                  device: torch.device) -> torch.Tensor:
    """(2, n_fft, n_bins_pad) window-folded cos/sin tables, zero-padded."""
    table = plain.dft_table(n_fft, device)
    padded = torch.zeros(2, n_fft, n_bins_pad, dtype=torch.float32,
                         device=device)
    padded[:, :, : table.shape[-1]] = table
    return padded


def launch_log_spectrogram(waveform: torch.Tensor, n_fft: int = 256,
                           hop: int = 128, eps: float = 1e-7) -> torch.Tensor:
    """Run the kernel on a contiguous (B, N) fp32 CUDA tensor; raises on
    anything it does not take (a CPU tensor included)."""
    if not waveform.is_cuda:
        raise ValueError(
            f"the CUDA log-spectrogram kernel needs a CUDA tensor, got "
            f"{waveform.device}")
    if waveform.dtype != torch.float32 or waveform.dim() != 2:
        raise ValueError(f"need a (B, N) float32 waveform, got "
                         f"{tuple(waveform.shape)} {waveform.dtype}")
    if not waveform.is_contiguous():
        raise ValueError("need a contiguous waveform")
    b, n = waveform.shape
    if n_fft < 2 or hop < 1 or n <= n_fft // 2 or not 0 < b <= 65535:
        raise ValueError(f"unsupported shape (B={b}, N={n}) for n_fft="
                         f"{n_fft}, hop={hop}")
    lib = _lib()
    n_bins = n_fft // 2 + 1
    tile = lib.mmct_log_spectrogram_freq_tile()
    n_bins_pad = -(-n_bins // tile) * tile
    frames = plain.num_frames(n, n_fft, hop)
    table = _device_table(n_fft, n_bins_pad, waveform.device)
    out = torch.empty(b, n_bins, frames, dtype=torch.float32,
                      device=waveform.device)
    with torch.cuda.device(waveform.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmct_log_spectrogram(
            waveform.data_ptr(), table.data_ptr(), out.data_ptr(), b, n,
            n_fft, hop, n_bins, n_bins_pad, frames, eps, stream)
    if err != 0:
        raise RuntimeError("log_spectrogram kernel launch failed: "
                           + lib.mmct_cuda_error_string(err).decode())
    launch_log_spectrogram.launches += 1
    return out


launch_log_spectrogram.launches = 0


def log_spectrogram(waveform: torch.Tensor, n_fft: int = 256, hop: int = 128,
                    eps: float = 1e-7) -> torch.Tensor:
    """(B, N) waveform -> (B, n_fft//2 + 1, T) fp32 log-|STFT|: the kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if waveform.device.type == "cpu":
        return plain.log_spectrogram(waveform, n_fft=n_fft, hop=hop, eps=eps)
    return launch_log_spectrogram(waveform.float().contiguous(), n_fft=n_fft,
                                  hop=hop, eps=eps)
