"""STFT log-spectrograms as plain PyTorch (port of
``multimodal_clinical_tpu/ops/spectrogram.py``): VGGSound's
``log_spectrogram`` and Crema-D/AVE's ``cremad_spectrogram``.

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


def _tukey_periodic(M: int, alpha: float) -> np.ndarray:
    """Periodic (fftbins=True) Tukey window — scipy.signal.get_window's
    construction: tukey(M + 1, alpha, sym=True) truncated by one sample."""
    n = np.arange(M + 1, dtype=np.float64)
    m = M  # = (M + 1) - 1
    width = int(np.floor(alpha * m / 2.0))
    w = np.ones(M + 1, dtype=np.float64)
    n1 = n[: width + 1]
    w[: width + 1] = 0.5 * (1 + np.cos(np.pi * (-1 + 2.0 * n1 / alpha / m)))
    n3 = n[-(width + 1):]
    w[-(width + 1):] = 0.5 * (
        1 + np.cos(np.pi * (-2.0 / alpha + 1 + 2.0 * n3 / alpha / m)))
    return w[:-1]


@functools.lru_cache(maxsize=8)
def _psd_tables(nperseg: int, fs: int, device: torch.device):
    """(window (nperseg,), per-bin density scale (nperseg//2 + 1,)) fp32
    on ``device``: the periodic tukey(0.25) window, and the one-sided
    density scaling (x2 except DC and, for even nperseg, Nyquist, over
    fs * sum(win^2)), both computed in float64."""
    win = _tukey_periodic(nperseg, 0.25)
    sided = np.full(nperseg // 2 + 1, 2.0)
    sided[0] = 1.0
    if nperseg % 2 == 0:
        sided[-1] = 1.0
    scale = sided / (float(fs) * float(np.sum(win ** 2)))
    return (torch.from_numpy(win.astype(np.float32)).to(device),
            torch.from_numpy(scale.astype(np.float32)).to(device))


def cremad_spectrogram(waveform: torch.Tensor, nperseg: int = 512,
                       noverlap: int = 353, fs: int = 16000,
                       standardize: bool = True,
                       eps: float = 1e-7) -> torch.Tensor:
    """(B, N) waveform -> (B, nperseg//2 + 1, T) fp32: the
    scipy.signal.spectrogram PSD -> log -> per-clip standardisation of the
    Crema-D and AVE offline pipelines (cremad/video_preprocessing.py:
    234-238, ave/video_preprocessing.py:267-271, both at 16 kHz).

    Every scipy.signal.spectrogram default the reference relies on:
    periodic tukey(0.25) window, per-segment constant detrend, one-sided
    density scaling, boundary=None/padded=False framing.  The DFT is
    ``torch.fft.rfft`` in fp32 (the JAX package's is a matmul outside any
    kernel).  The standardisation divides by the population std (ddof 0,
    as ``jnp.std``) plus the reference's 1e-9."""
    hop = nperseg - noverlap
    frames = waveform.float().unfold(-1, nperseg, hop)       # (B, T, nperseg)
    frames = frames - frames.mean(dim=-1, keepdim=True)      # detrend
    win, scale = _psd_tables(nperseg, fs, frames.device)
    spectrum = torch.fft.rfft(frames * win, dim=-1)          # (B, T, F)
    power = (spectrum.real.square() + spectrum.imag.square()) * scale
    out = torch.log(power.transpose(1, 2) + eps)             # (B, F, T)
    if standardize:
        mean = out.mean(dim=(1, 2), keepdim=True)
        std = out.std(dim=(1, 2), keepdim=True, correction=0)
        out = (out - mean) / (std + 1e-9)
    return out.contiguous()
