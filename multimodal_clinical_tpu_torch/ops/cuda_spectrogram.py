"""CUDA log-spectrogram kernel (``csrc/log_spectrogram.cu``) and its wrapper.

Port of ``multimodal_clinical_tpu/ops/pallas_spectrogram.py``: the same
function as ``pallas_log_spectrogram`` — centred Hann STFT, log(|X| + eps),
(B, N) fp32 -> (B, n_fft//2 + 1, T) fp32 — for any hop, not only
hop == n_fft / 2, and n_fft a power of two from 64 to 1024.  The kernel is
a four-step FFT that takes two real frames per complex transform; this
module builds what it is handed (``fft_tables``: the digit plan, the
window and the twiddles) and says how the pairs are split.  The kernel's
source note says what bounds it and how its design answers.
``ops/spectrogram.log_spectrogram`` is its plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ..kernels import build
from . import spectrogram as plain

# n_fft -> (N1, N2), n_fft = N1 N2: the kernel runs N1-point FFTs over
# n1 of x[N2 n1 + n2], twiddles by W^(n2 k1), then N2-point FFTs over n2;
# bin k = k1 + N1 k2.  One template instance per entry.
FFT_PLANS = {64: (8, 8), 128: (16, 8), 256: (16, 16), 512: (32, 16),
             1024: (32, 32)}


def fft_tables(n_fft: int) -> Tuple[int, int, np.ndarray, np.ndarray]:
    """(N1, N2, window, twiddle) for the kernel: the digit plan, the
    periodic Hann window (n_fft,) and W^m = exp(-2 pi i m / n_fft) as
    (n_fft, 2) (cos, sin) pairs, both computed in float64 and cast to
    float32 once.  Raises ``ValueError`` for an n_fft without a plan."""
    if n_fft not in FFT_PLANS:
        raise ValueError(f"the CUDA log-spectrogram kernel takes n_fft a power "
                         f"of two from 64 to 1024 ({sorted(FFT_PLANS)}), got "
                         f"{n_fft}")
    n1, n2 = FFT_PLANS[n_fft]
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    ang = -2.0 * np.pi * np.arange(n_fft) / n_fft
    twiddle = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return n1, n2, window, twiddle


def split_pairs(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split the kernel's epilogue makes: frames t and t + 1 go through
    one transform as z = x_t + i x_{t+1}; from Z (..., n) complex, its FFT,
    X_t[k] = (Z[k] + conj Z[-k]) / 2 and X_{t+1}[k] = (Z[k] - conj Z[-k]) /
    2i for k = 0 .. n / 2."""
    n = z.shape[-1]
    k = torch.arange(n // 2 + 1, device=z.device)
    a, c = z[..., k], z[..., (-k) % n].conj()
    return (a + c) / 2, (a - c) / 2j


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("log_spectrogram")
    lib.mmct_log_spectrogram.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # wave, tw, window
        ctypes.c_void_p,                                     # out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, N, n_fft
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # N1, N2, hop
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p,       # T, eps, stream
    ]
    lib.mmct_log_spectrogram.restype = ctypes.c_int
    lib.mmct_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mmct_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=8)
def _device_tables(n_fft: int, device: torch.device):
    """(window, twiddle) of ``fft_tables`` on ``device``, built once."""
    _, _, window, twiddle = fft_tables(n_fft)
    return (torch.from_numpy(window).to(device),
            torch.from_numpy(twiddle).to(device))


def launch_log_spectrogram(waveform: torch.Tensor, n_fft: int = 256,
                           hop: int = 128, eps: float = 1e-7) -> torch.Tensor:
    """Run the kernel on a contiguous (B, N) fp32 CUDA tensor; raises on
    anything it does not take (a CPU tensor included)."""
    n1, n2 = fft_tables(n_fft)[:2]  # an n_fft without a plan raises first
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
    if hop < 1 or n <= n_fft // 2 or not 0 < b <= 65535:
        raise ValueError(f"unsupported shape (B={b}, N={n}) for n_fft="
                         f"{n_fft}, hop={hop}")
    lib = _lib()
    frames = plain.num_frames(n, n_fft, hop)
    window, twiddle = _device_tables(n_fft, waveform.device)
    out = torch.empty(b, n_fft // 2 + 1, frames, dtype=torch.float32,
                      device=waveform.device)
    with torch.cuda.device(waveform.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmct_log_spectrogram(
            waveform.data_ptr(), twiddle.data_ptr(), window.data_ptr(),
            out.data_ptr(), b, n, n_fft, n1, n2, hop, frames, eps, stream)
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
