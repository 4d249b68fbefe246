"""Enrico: UI screenshot and wireframe images, 20 design topics (port of
``multimodal_clinical_tpu/benchmarks/enrico.py``).

Data (reference enrico/get_data.py:40-200): ``<data_path>/design_topics.csv``
with screen ids and topics, ``screenshots/<id>.jpg`` and
``wireframes/<id>.png``; the corrupted ids {50105, 50109} dropped; a
shuffle of ``random.Random(42)`` split 65/15/20; images resized to
256 x 128 and held as uint8 (ToTensor's /255 runs on the device, in
``device_preprocess``); an inverse-frequency weighted train sampler.  The
~1.4k images are decoded once, up front.  Modality noise
(enrico/get_data_noised.py:135-186): with probability ``noise_p`` a train
sample's screenshot is swapped for one of another class, and
``label_noise_p`` redraws labels uniformly.

Model types (enrico/__init__.py):
  jlogits         ResNet18Slim pair, frozen features, StepLR(10, 0.5);
  ensemble        unfrozen features, StepLR(70, 0.5);
  ensemble_vicreg ensemble + 0.1 * VICReg(emb1, emb2);
  ensemble_counts / jlogits_counts  the analysis variants: per-head
                  min-loss counters, and jlogits_counts on the VGG11Slim
                  pair with its conv stack frozen.
SGD (momentum 0.9, weight decay 1e-4 off the frozen towers).  ImageNet
weights come from a local torchvision resnet18 state_dict
(``torchvision_weights``), never downloaded.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import random
from typing import Dict, Tuple

import numpy as np
import torch

from ..data.core import ArrayDataset
from ..data.imageops import _quantize_u8, pil_resize_u8, to_unit_floats_device
from ..data.synthetic import make_synthetic_splits
from ..engine.run import DataBundle
from ..engine.spec import ModelSpec, resolve_dtype
from ..models.zoo import EnricoFusionNet, EnricoVGGFusionNet
from ..utils.native import decode_jpeg

MODEL_TYPES = ("jlogits", "ensemble", "ensemble_vicreg", "ensemble_counts",
               "jlogits_counts")
IGNORES = {"50105", "50109"}
TOWERS = ("x1_model", "x2_model")


def _decode_image(path: str, size=(256, 128)) -> np.ndarray:
    """Decode and resize to (H, W, 3) uint8, the post-resize stage of the
    reference's transforms.Resize((256, 128)).  JPEGs go through the
    native libjpeg decode where it loads; PNGs (the wireframes) and the
    fallback through PIL, BILINEAR as torchvision's Resize."""
    if path.endswith((".jpg", ".jpeg")):
        out = decode_jpeg(path, size[0], size[1])
        if out is not None:
            return _quantize_u8(out)
    return pil_resize_u8(path, size[1], size[0])


def _load_real(data_dir: str, seed42: int = 42):
    with open(os.path.join(data_dir, "design_topics.csv")) as f:
        examples = [e for e in csv.DictReader(f)
                    if e["screen_id"] not in IGNORES]
    topics = sorted({e["topic"] for e in examples})
    topic2idx = {t: i for i, t in enumerate(topics)}

    keys = list(range(len(examples)))
    random.Random(seed42).shuffle(keys)
    n = len(examples)
    splits = (keys[: int(n * 0.65)], keys[int(n * 0.65): int(n * 0.80)],
              keys[int(n * 0.80):])

    def build(split_keys):
        imgs, wires, labels = [], [], []
        for k in split_keys:
            sid = examples[k]["screen_id"]
            imgs.append(_decode_image(os.path.join(data_dir, "screenshots",
                                                   sid + ".jpg")))
            wires.append(_decode_image(os.path.join(data_dir, "wireframes",
                                                    sid + ".png")))
            labels.append(topic2idx[examples[k]["topic"]])
        return ArrayDataset([np.stack(imgs), np.stack(wires)],
                            np.asarray(labels, np.int32))

    return tuple(build(k) for k in splits)


def _apply_noise(train: ArrayDataset, noise_p: float, label_noise_p: float,
                 num_classes: int, seed: int) -> ArrayDataset:
    """Cross-class x1 swap and label noise (enrico/get_data_noised.py:
    135-186), drawn from ``default_rng((seed, 1234))``."""
    rng = np.random.default_rng((seed, 1234))
    x1, x2 = train.modalities
    labels = train.labels.copy()
    n = len(labels)
    if noise_p > 0:
        x1 = x1.copy()
        swap_mask = rng.random(n) < noise_p
        for i in np.nonzero(swap_mask)[0]:
            other = np.nonzero(labels != labels[i])[0]
            if len(other):
                x1[i] = train.modalities[0][rng.choice(other)]
    if label_noise_p > 0:
        flip = rng.random(n) < label_noise_p
        labels[flip] = rng.integers(0, num_classes, size=int(flip.sum()))
    return ArrayDataset([x1, x2], labels)


def get_data(args) -> DataBundle:
    data_dir = getattr(args, "data_path", "data/enrico/")
    if os.path.exists(os.path.join(data_dir, "design_topics.csv")):
        train, val, test = _load_real(data_dir)
        synthetic = False
    else:
        print(f"[enrico] real data not found under {data_dir!r}; "
              "using synthetic twin")
        train, val, test = make_synthetic_splits(
            "enrico", int(args.num_classes), int(getattr(args, "seed", 0)),
            n_train=128, n_val=32, n_test=32)
        synthetic = True
    noise_p = float(getattr(args, "noise_p", 0.0) or 0.0)
    label_noise_p = float(getattr(args, "label_noise_p", 0.0) or 0.0)
    if noise_p or label_noise_p:
        train = _apply_noise(train, noise_p, label_noise_p,
                             int(args.num_classes),
                             int(getattr(args, "seed", 0)))
    return DataBundle(train, val, test, train_sampler="weighted",
                      synthetic=synthetic)


def load_pretrained(args, state):
    """ImageNet resnet18 weights from a local torchvision checkpoint
    (``torchvision_weights``: a state_dict saved with ``torch.save``) into
    both towers' ``features``, in place; the reference downloads them at
    construction (enrico/joint_model.py:28).  A no-op when unset."""
    ckpt = getattr(args, "torchvision_weights", None)
    if not ckpt:
        return state
    sd = torch.load(ckpt, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    for tower in TOWERS:
        features = getattr(state.model, tower).features
        # torchvision's fc and num_batches_tracked have no place here
        features.load_state_dict({k: sd[k] for k in features.state_dict()})
    print(f"[enrico] loaded torchvision resnet18 weights from {ckpt}")
    return state


def get_model_spec(args, n_train: int) -> Tuple[ModelSpec, Dict]:
    model_type = getattr(args, "model_type", "jlogits")
    num_classes = int(args.num_classes)
    # the config's dropout_p (0.1) reaches the VGG variant; an unset or
    # zero value gives 0.2
    dropout_p = float(getattr(args, "dropout_p", 0.2) or 0.2)
    dtype = resolve_dtype(args)
    if model_type in ("jlogits", "jlogits_counts"):
        if model_type == "jlogits_counts":
            module = EnricoVGGFusionNet(num_classes, dropout_p=dropout_p,
                                        dtype=dtype)
        else:
            module = EnricoFusionNet(num_classes, freeze_features=True,
                                     dtype=dtype)
        # both towers keep their frozen conv stacks under ``features``
        # (the JAX VGG11Slim's inline Conv_* / TorchBatchNorm_*)
        spec = ModelSpec(module=module, contract="jlogits",
                         sched_step_size=10, sched_gamma=0.5,
                         frozen_prefixes=tuple(f"{t}.features"
                                               for t in TOWERS),
                         track_min_loss_counts=(model_type
                                                == "jlogits_counts"))
    elif model_type in ("ensemble", "ensemble_counts", "ensemble_vicreg"):
        module = EnricoFusionNet(num_classes, freeze_features=False,
                                 dtype=dtype)
        spec = ModelSpec(module=module, contract="ensemble",
                         vicreg_weight=(0.1 if model_type == "ensemble_vicreg"
                                        else 0.0),
                         sched_step_size=70, sched_gamma=0.5,
                         track_min_loss_counts=(model_type
                                                == "ensemble_counts"))
    else:
        # enrico/joint_model_proba.py is unreachable from the reference's
        # factory (enrico/__init__.py): no jprobas variant
        raise NotImplementedError(f"enrico model_type {model_type!r}")
    return dataclasses.replace(spec, device_preprocess=device_preprocess), {}


def device_preprocess(batch, generator, train: bool):
    """uint8 screenshots and wireframes -> float32 in [0, 1] on the device
    (ToTensor; Enrico applies no ImageNet normalisation,
    enrico/get_data.py:94-103).  Float inputs (the twin) pass through."""
    batch = dict(batch)
    batch["x1"] = to_unit_floats_device(batch["x1"])
    batch["x2"] = to_unit_floats_device(batch["x2"])
    return batch
