"""VGGSound device preprocessing and model spec (port of
``multimodal_clinical_tpu/benchmarks/vggsound.py:391-443``; the data
adapters come with ROADMAP.md queue A, item 8)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..data.imageops import normalize_frames_device
from ..engine.spec import ModelSpec, resolve_dtype
from ..models.zoo import CremadFusionNet
from ..ops.cuda_spectrogram import log_spectrogram
from ..ops.specaugment import apply_masks, spec_augment_masks

N_FFT = 256
HOP = 128
# torchaudio masks of vggsound/get_data.py:18-45
SPEC_AUGMENT = dict(freq_mask_param=30, time_mask_param=120,
                    num_freq_masks=2, num_time_masks=3)


def device_preprocess(batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator], train: bool):
    """Raw waveform -> (B, 129, T, 1) log-spectrogram (+ SpecAugment at
    train) on the waveform's device (vggsound/get_data.py:106-128).  The
    spectrogram is the CUDA kernel for a CUDA tensor, its plain version for
    a CPU one; uint8 frames are ImageNet-normalised, float frames pass."""
    batch = dict(batch)
    batch["x2"] = normalize_frames_device(batch["x2"])
    if "x1_waveform" not in batch:
        return batch
    spec2d = log_spectrogram(batch.pop("x1_waveform"), n_fft=N_FFT, hop=HOP)
    if train:
        b, f, t = spec2d.shape
        fmask, tmask = spec_augment_masks(generator, b, f, t, spec2d.device,
                                          **SPEC_AUGMENT)
        spec2d = apply_masks(spec2d, fmask, tmask)
    batch["x1"] = spec2d[..., None]
    return batch


def get_model_spec(args, n_train: int) -> Tuple[ModelSpec, Dict]:
    model_type = getattr(args, "model_type", "jprobas")
    if model_type != "jprobas":
        raise NotImplementedError(
            f"vggsound model_type {model_type!r} is not ported yet "
            "(ROADMAP.md queue A, item 11)")
    module = CremadFusionNet(num_classes=int(args.num_classes),
                             dtype=resolve_dtype(args))
    spec = ModelSpec(module=module, contract="jprobas", sched_step_size=30,
                     sched_gamma=0.5, device_preprocess=device_preprocess)
    return spec, {}
