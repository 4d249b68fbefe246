"""Crema-D: audio log-spectrogram + 3 video frames, 6-way emotion
classification (port of ``multimodal_clinical_tpu/benchmarks/cremad.py:
379-448``).

All ten model variants of the reference factory (cremad/__init__.py:4-23):
jlogits / jprobas / ensemble (CE x3, cremad/ensemble_model.py:54-55) /
ogm_ge (alpha from the config) / ensemble_ogm_ge (ensemble + modulation,
ensemble_model_noised.py:118-123) / qmf / qmf_ablate / qmf_ablate_Ljoint /
qmf_ablate_Lunimodal / ogm_ge_lreg (QMF loss + OGM-GE modulation,
joint_model_ogm_ge_lreg.py).

``get_data`` serves the synthetic twin (64/32/32 rows: the (257, 1004)
spectrogram ``x1`` and three 224 x 224 frames); the disk dataset
(``train.csv`` and its pickled spectrograms, wav or container audio and
frames under ``data_path``) comes with ROADMAP.md queue A, item 8b.  A
waveform ``x1_waveform`` becomes the (257, 1004) log-spectrogram inside
the step (``ops/spectrogram.py::cremad_spectrogram``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch

from ..data.imageops import normalize_frames_device
from ..data.synthetic import make_synthetic_splits
from ..engine.run import DataBundle
from ..engine.spec import ModelSpec, resolve_dtype
from ..models.zoo import CremadFusionNet
from ..ops.spectrogram import cremad_spectrogram
from . import disk_data_not_ported

MODEL_TYPES = ("jlogits", "jprobas", "ensemble", "ogm_ge", "ensemble_ogm_ge",
               "qmf", "qmf_ablate", "qmf_ablate_Ljoint",
               "qmf_ablate_Lunimodal", "ogm_ge_lreg")


def get_data(args) -> DataBundle:
    data_dir = getattr(args, "data_path", "data/cremad/")
    csv_path = os.path.join(data_dir, "train.csv")
    if os.path.exists(csv_path):
        raise disk_data_not_ported(csv_path, "Crema-D")
    print(f"[cremad] real data not found under {data_dir!r}; "
          "using synthetic twin", flush=True)
    train, val, test = make_synthetic_splits(
        "cremad", int(args.num_classes), int(getattr(args, "seed", 0)),
        n_train=64, n_val=32, n_test=32,
    )
    # balanced samplers on train and val, sequential test
    # (cremad/run_trainer.py:40-70)
    return DataBundle(train, val, test, train_sampler="weighted",
                      val_sampler="weighted", synthetic=True)


def device_preprocess(batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator], train: bool):
    """uint8 frames -> ImageNet-normalised fp32 on the device (float frames
    pass); a waveform ``x1_waveform`` -> the (B, 257, T, 1) log-spectrogram
    (the math the offline cremad-audio stage pickles,
    video_preprocessing.py:119-130).  No augmentation: SpecAugment is
    dormant in cremad/get_data.py:17-48."""
    batch = dict(batch)
    batch["x2"] = normalize_frames_device(batch["x2"])
    if "x1_waveform" in batch:
        batch["x1"] = cremad_spectrogram(batch.pop("x1_waveform"))[..., None]
    return batch


def get_model_spec(args, n_train: int) -> Tuple[ModelSpec, Dict]:
    model_type = getattr(args, "model_type", "jlogits")
    module = CremadFusionNet(num_classes=int(args.num_classes),
                             dtype=resolve_dtype(args))
    alpha = float(getattr(args, "alpha", 0.8))
    grad_mod = getattr(args, "grad_mod_type", "OGM_GE")
    qmf = dict(contract="qmf", n_train_samples=n_train)

    if model_type == "jlogits":
        spec = ModelSpec(module=module, contract="jlogits")
    elif model_type == "jprobas":
        spec = ModelSpec(module=module, contract="jprobas")
    elif model_type == "ensemble":
        spec = ModelSpec(module=module, contract="ensemble",
                         unimodal_loss_scale=3.0)
    elif model_type == "ogm_ge":
        spec = ModelSpec(module=module, contract="ogm_ge",
                         grad_mod_type=grad_mod, ogm_alpha=alpha)
    elif model_type == "ensemble_ogm_ge":
        # plain CE (no x3.0, ensemble_model_noised.py:56-57), trained on
        # the MEAN (ensemble_model_noised.py:104)
        spec = ModelSpec(module=module, contract="ensemble",
                         ensemble_train_mean=True, apply_grad_mod=True,
                         grad_mod_type=grad_mod, ogm_alpha=alpha)
    elif model_type == "qmf":
        spec = ModelSpec(module=module, **qmf)
    elif model_type == "qmf_ablate":
        spec = ModelSpec(module=module, qmf_ablate_train=True, **qmf)
    elif model_type == "qmf_ablate_Ljoint":
        spec = ModelSpec(module=module, qmf_drop_joint=True, **qmf)
    elif model_type == "qmf_ablate_Lunimodal":
        spec = ModelSpec(module=module, qmf_drop_unimodal=True, **qmf)
    elif model_type == "ogm_ge_lreg":
        spec = ModelSpec(module=module, apply_grad_mod=True,
                         grad_mod_type=grad_mod, ogm_alpha=alpha, **qmf)
    else:
        raise NotImplementedError(f"cremad model_type {model_type!r}")
    return dataclasses.replace(spec, device_preprocess=device_preprocess), {}
