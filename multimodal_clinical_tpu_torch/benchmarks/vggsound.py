"""VGGSound: data, device preprocessing and model spec (port of
``multimodal_clinical_tpu/benchmarks/vggsound.py:337-443``), under
jlogits / jprobas / ensemble.

``get_data`` serves the synthetic twin (64/32/32 rows, the spectrogram
``x1`` and four frames of ``x2`` at the reference's geometry); the disk
dataset (wav, JPEG and mp4 under ``data_path``) comes with ROADMAP.md
queue A, item 8b."""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from ..data.imageops import normalize_frames_device
from ..data.synthetic import make_synthetic_splits
from ..engine.run import DataBundle
from ..engine.spec import ModelSpec, resolve_dtype
from ..models.zoo import CremadFusionNet
from ..ops.cuda_spectrogram import log_spectrogram
from ..ops.specaugment import apply_masks, spec_augment_masks
from . import disk_data_not_ported

N_FFT = 256
HOP = 128
# torchaudio masks of vggsound/get_data.py:18-45
SPEC_AUGMENT = dict(freq_mask_param=30, time_mask_param=120,
                    num_freq_masks=2, num_time_masks=3)


def get_data(args) -> DataBundle:
    data_dir = getattr(args, "data_path", "data/vggsound/")
    csv_path = os.path.join(data_dir, "vggsound.csv")
    if os.path.exists(csv_path):
        raise disk_data_not_ported(csv_path, "VGGSound")
    print(f"[vggsound] real data not found under {data_dir!r}; "
          "using synthetic twin", flush=True)
    train, val, test = make_synthetic_splits(
        "vggsound", int(args.num_classes), int(getattr(args, "seed", 0)),
        n_train=64, n_val=32, n_test=32,
    )
    # balanced samplers on train AND val (vggsound/run_training.py:62-80;
    # val aliases the test set there); test iteration is sequential
    return DataBundle(train, val, test, train_sampler="weighted",
                      val_sampler="weighted", synthetic=True)


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
    module = CremadFusionNet(num_classes=int(args.num_classes),
                             dtype=resolve_dtype(args))
    common = dict(sched_step_size=30, sched_gamma=0.5,
                  device_preprocess=device_preprocess,
                  # legacy runner: no ModelCheckpoint, test on the
                  # final-epoch weights (vggsound/run_training.py:106-130)
                  test_restore_best=False,
                  # flat epoch-end names (vggsound/ensemble_model.py:
                  # 171-174)
                  legacy_metric_aliases=True)
    if model_type == "jlogits":
        spec = ModelSpec(module=module, contract="jlogits", **common)
    elif model_type == "jprobas":
        spec = ModelSpec(module=module, contract="jprobas", **common)
    elif model_type == "ensemble":
        # legacy dir: the train loss is the MEAN
        # (vggsound/ensemble_model.py:114)
        spec = ModelSpec(module=module, contract="ensemble",
                         ensemble_train_mean=True, **common)
    else:
        raise NotImplementedError(f"vggsound model_type {model_type!r}")
    return spec, {}
