"""STFT log-spectrogram as plain PyTorch (port of
``multimodal_clinical_tpu/ops/spectrogram.py``).

``log_spectrogram`` is the plain version of the CUDA kernel in
``ops/cuda_spectrogram.py``: the CPU path, and what the kernel is held
against on the card.  It matches librosa.stft defaults as used by
vggsound/get_data.py:118-119 — centred reflect pad, periodic Hann window,
one-sided DFT — then ``log(|X| + eps)``.

The window is folded into the DFT tables in float64 with numpy and cast to
fp32 once (as ``pallas_spectrogram.py`` builds its tables), so the kernel
and this function multiply by the same fp32 numbers and differ only in
summation order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def window_folded_dft(n_fft: int) -> np.ndarray:
    """(2, n_fft, n_fft//2 + 1) float32: Hann-windowed cos and sin DFT
    analysis tables, computed in float64."""
    k = np.arange(n_fft)[:, None]
    f = np.arange(n_fft // 2 + 1)[None, :]
    ang = -2.0 * np.pi * k * f / n_fft
    win = np.hanning(n_fft + 1)[:-1][:, None]  # periodic Hann
    return np.stack([np.cos(ang) * win, np.sin(ang) * win]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def dft_table(n_fft: int, device: torch.device) -> torch.Tensor:
    """``window_folded_dft(n_fft)`` as a tensor on ``device``, built once."""
    return torch.from_numpy(window_folded_dft(n_fft)).to(device)


def num_frames(n: int, n_fft: int, hop: int) -> int:
    """Frames of a centred STFT of ``n`` samples."""
    return 1 + (n + 2 * (n_fft // 2) - n_fft) // hop


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(B, N) -> (B, T, frame_length) centred frames (librosa-style reflect
    pad of frame_length // 2 on each side)."""
    pad = frame_length // 2
    x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    return x.unfold(-1, frame_length, hop)


def log_spectrogram(waveform: torch.Tensor, n_fft: int = 256, hop: int = 128,
                    eps: float = 1e-7) -> torch.Tensor:
    """(B, N) waveform -> (B, n_fft//2 + 1, T) fp32 log-magnitude STFT."""
    frames = frame_signal(waveform.float(), n_fft, hop)       # (B, T, n_fft)
    table = dft_table(n_fft, frames.device)
    re = frames @ table[0]                                    # (B, T, F)
    im = frames @ table[1]
    out = torch.log(torch.sqrt(re * re + im * im) + eps)
    return out.transpose(1, 2).contiguous()
