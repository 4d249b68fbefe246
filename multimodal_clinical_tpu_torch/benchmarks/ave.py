"""AVE: Audio-Visual Event, 28-way classification, PMR protocol (port of
``multimodal_clinical_tpu/benchmarks/ave.py:252-299``).

Scratch dual ResNet18 as Crema-D, with 6 distinct frames per clip
(ave/get_data.py:135), SpecAugment at train with reduced parameters
(ave/get_data.py:148-155) and the legacy StepLR(10, 0.5)
(ave/joint_model.py:250-258), under jlogits / jprobas / ensemble.

``get_data`` serves the synthetic twin (64/32/32 rows); the disk dataset
(``testSet.txt`` and the other split lists, pickled spectrograms, wav or
container audio and frames under ``data_path``) comes with ROADMAP.md
queue A, item 8b.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from ..data.imageops import normalize_frames_device
from ..data.synthetic import make_synthetic_splits
from ..engine.run import DataBundle
from ..engine.spec import ModelSpec, resolve_dtype
from ..models.zoo import CremadFusionNet
from ..ops.specaugment import apply_masks, spec_augment_masks
from ..ops.spectrogram import cremad_spectrogram
from . import disk_data_not_ported

MODEL_TYPES = ("jlogits", "jprobas", "ensemble")
NUM_FRAMES = 6
# the reduced masks of ave/get_data.py:148-155
SPEC_AUGMENT = dict(freq_mask_param=15, time_mask_param=60,
                    num_freq_masks=1, num_time_masks=1)


def get_data(args) -> DataBundle:
    data_dir = getattr(args, "data_path", "data/ave/")
    test_txt = os.path.join(data_dir, "testSet.txt")
    if os.path.exists(test_txt):
        raise disk_data_not_ported(test_txt, "AVE")
    print(f"[ave] real data not found under {data_dir!r}; "
          "using synthetic twin", flush=True)
    train, val, test = make_synthetic_splits(
        "ave", int(args.num_classes), int(getattr(args, "seed", 0)),
        n_train=64, n_val=32, n_test=32,
    )
    # balanced samplers on train and val; the test sampler is built but
    # never passed to the test DataLoader (ave/run_training.py:84-92)
    return DataBundle(train, val, test, train_sampler="weighted",
                      val_sampler="weighted", synthetic=True)


def device_preprocess(batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator], train: bool):
    """uint8 frames -> ImageNet-normalised fp32 (float frames pass); a
    waveform ``x1_waveform`` -> the (B, 257, T, 1) log-spectrogram (the
    extractWav_SE pickle math, ave/video_preprocessing.py:268-276); at
    train, one frequency and one time mask drawn from the step's
    generator (ave/get_data.py:148-155)."""
    batch = dict(batch)
    batch["x2"] = normalize_frames_device(batch["x2"])
    if "x1_waveform" in batch:
        batch["x1"] = cremad_spectrogram(batch.pop("x1_waveform"))[..., None]
    if not train:
        return batch
    spec2d = batch["x1"][..., 0]
    b, f, t = spec2d.shape
    fmask, tmask = spec_augment_masks(generator, b, f, t, spec2d.device,
                                      **SPEC_AUGMENT)
    batch["x1"] = apply_masks(spec2d, fmask, tmask)[..., None]
    return batch


def get_model_spec(args, n_train: int) -> Tuple[ModelSpec, Dict]:
    model_type = getattr(args, "model_type", "jprobas")
    module = CremadFusionNet(num_classes=int(args.num_classes),
                             dtype=resolve_dtype(args))
    common = dict(sched_step_size=10, sched_gamma=0.5,
                  device_preprocess=device_preprocess,
                  # legacy runner: no ModelCheckpoint, test on the
                  # final-epoch weights (ave/run_training.py:106-131)
                  test_restore_best=False,
                  # flat epoch-end names (ave/joint_model.py:197-201)
                  legacy_metric_aliases=True)
    if model_type == "jlogits":
        spec = ModelSpec(module=module, contract="jlogits", **common)
    elif model_type == "jprobas":
        spec = ModelSpec(module=module, contract="jprobas", **common)
    elif model_type == "ensemble":
        # legacy dir: the train loss is the MEAN (ave/ensemble_model.py:115)
        spec = ModelSpec(module=module, contract="ensemble",
                         ensemble_train_mean=True, **common)
    else:
        raise NotImplementedError(f"ave model_type {model_type!r}")
    return spec, {}
