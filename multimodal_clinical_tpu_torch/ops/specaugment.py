"""SpecAugment frequency + time masking (port of
``multimodal_clinical_tpu/ops/specaugment.py``).

Split in two: the draws (``draw_bands``, from an explicit CPU
``torch.Generator``, so a run on the card and one on the CPU draw the same
bands) and the masks built and applied on the spectrogram's device
(``band_mask``, ``apply_masks``); ``spec_augment_masks`` draws one batch's
masks, frequency bands first.  torchaudio semantics as in the JAX
module: width ~ randint[0, param), start = int(U[0, 1) * max(dim - width, 1)),
masked bins zeroed.
"""

from __future__ import annotations

from typing import Tuple

import torch


def draw_bands(generator: torch.Generator, batch: int, dim: int,
               mask_param: int, num_masks: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(widths, starts), each (B, num_masks) int64 on the CPU."""
    widths = torch.randint(0, mask_param, (batch, num_masks),
                           generator=generator)
    u = torch.rand((batch, num_masks), generator=generator)
    starts = (u * torch.clamp(dim - widths, min=1)).to(torch.int64)
    return widths, starts


def band_mask(widths: torch.Tensor, starts: torch.Tensor, dim: int,
              device) -> torch.Tensor:
    """(B, dim) float32 multiplicative mask, zero inside any band."""
    widths = widths.to(device)
    starts = starts.to(device)
    pos = torch.arange(dim, device=device)[None, None, :]
    banded = ((pos >= starts[..., None])
              & (pos < (starts + widths)[..., None]))
    return 1.0 - banded.any(dim=1).to(torch.float32)


def apply_masks(spectrogram: torch.Tensor, fmask: torch.Tensor,
                tmask: torch.Tensor) -> torch.Tensor:
    """(B, F, T) spectrogram times (B, F) and (B, T) masks."""
    return spectrogram * fmask[:, :, None] * tmask[:, None, :]


def spec_augment_masks(generator, batch: int, f: int, t: int,
                       device, freq_mask_param: int = 30,
                       time_mask_param: int = 120, num_freq_masks: int = 2,
                       num_time_masks: int = 3
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fmask (B, F), tmask (B, T)) for one batch: frequency bands drawn
    first, then time bands.  ``generator`` may be a sequence of S
    generators (the multi-seed sweep's, one a seed): row block s of the
    S equal blocks then takes generator s's draws, those of a batch of
    B / S rows."""
    gens = (list(generator) if isinstance(generator, (list, tuple))
            else [generator])
    per = batch // len(gens)
    draws = [draw_bands(g, per, f, freq_mask_param, num_freq_masks)
             + draw_bands(g, per, t, time_mask_param, num_time_masks)
             for g in gens]
    fw, fs, tw, ts = (torch.cat(parts) for parts in zip(*draws))
    return band_mask(fw, fs, f, device), band_mask(tw, ts, t, device)
