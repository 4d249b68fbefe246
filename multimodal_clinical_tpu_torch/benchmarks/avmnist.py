"""AV-MNIST: a 28 x 28 digit image and a 112 x 112 audio spectrogram,
10-way (port of ``multimodal_clinical_tpu/benchmarks/avmnist.py``).

Data (reference avmnist/get_data.py:25-58): six ``.npy`` arrays,
``<data_path>/image/{train,test}_data.npy``,
``<data_path>/audio/{train,test}_data.npy`` and
``<data_path>/{train,test}_labels.npy``; divided by 255; a 55k/5k/10k
train/val/test split.  Without ``train_labels.npy`` the synthetic twin
stands in.

Model types (avmnist/*.py, legacy self-contained Lightning modules), all
on ``AVMnistFusionNet`` (LeNet(6, 3) + LeNet(6, 5)):
  jlogits          CE on the mean logits;
  jprobas          CE on the log-mean-softmax (joint_model_proba.py:116-144);
  jprobas_jlogits  probas in training, logits at eval
                   (joint_model_proba_logits.py);
  ensemble         per-modality CE (ensemble_model.py:121-124);
  ensemble_probas  ensemble with log-prob reporting
                   (ensemble_model_probas.py).
Plain SGD with no momentum and no weight decay, no LR scheduler
(avmnist/joint_model.py:340-342).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from ..data.core import ArrayDataset
from ..data.synthetic import make_synthetic_splits
from ..engine.run import DataBundle
from ..engine.spec import ModelSpec, resolve_dtype
from ..models.zoo import AVMnistFusionNet

MODEL_TYPES = ("jlogits", "jprobas", "jprobas_jlogits", "ensemble",
               "ensemble_probas")
N_TRAIN = 55000


def _load_real(data_dir: str):
    def load(*parts):
        return np.load(os.path.join(data_dir, *parts))

    def prep(img, aud):
        img = (img.reshape(-1, 28, 28, 1) / 255.0).astype(np.float32)
        aud = (aud.reshape(-1, 112, 112, 1) / 255.0).astype(np.float32)
        return img, aud

    img_tr, aud_tr = prep(load("image", "train_data.npy"),
                          load("audio", "train_data.npy"))
    img_te, aud_te = prep(load("image", "test_data.npy"),
                          load("audio", "test_data.npy"))
    lab_tr = load("train_labels.npy").astype(np.int32)
    lab_te = load("test_labels.npy").astype(np.int32)
    train = ArrayDataset([img_tr[:N_TRAIN], aud_tr[:N_TRAIN]],
                         lab_tr[:N_TRAIN])
    val = ArrayDataset([img_tr[N_TRAIN:], aud_tr[N_TRAIN:]],
                       lab_tr[N_TRAIN:])
    test = ArrayDataset([img_te, aud_te], lab_te)
    return train, val, test


def get_data(args) -> DataBundle:
    data_dir = getattr(args, "data_path", "data/avmnist/")
    if os.path.exists(os.path.join(data_dir, "train_labels.npy")):
        train, val, test = _load_real(data_dir)
        synthetic = False
    else:
        print(f"[avmnist] real data not found under {data_dir!r}; "
              "using synthetic twin")
        train, val, test = make_synthetic_splits(
            "avmnist", int(args.num_classes), int(getattr(args, "seed", 0)))
        synthetic = True
    # the reference's train DataLoader passes neither a sampler nor
    # shuffle=True (avmnist/run_training.py:73-79): the same sequential
    # order every epoch
    return DataBundle(train, val, test, train_sampler="sequential",
                      synthetic=synthetic)


def get_model_spec(args, n_train: int) -> Tuple[ModelSpec, Dict]:
    model_type = getattr(args, "model_type", "jlogits")
    contract = {
        "jlogits": "jlogits",
        "jprobas": "jprobas",
        "jprobas_jlogits": "jprobas",
        "ensemble": "ensemble",
        "ensemble_probas": "ensemble",
    }.get(model_type)
    if contract is None:
        raise NotImplementedError(f"avmnist model_type {model_type!r}")
    module = AVMnistFusionNet(int(args.num_classes), dtype=resolve_dtype(args))
    spec = ModelSpec(
        module=module,
        contract=contract,
        eval_fusion="logits" if model_type == "jprobas_jlogits" else None,
        report_logprobs=(model_type == "ensemble_probas"),
        # the legacy dir trains on the MEAN of the per-modality losses
        # (avmnist/ensemble_model.py:195, ensemble_model_probas.py:205)
        ensemble_train_mean=True,
        # the legacy runner has no ModelCheckpoint: the test epoch runs on
        # the final-epoch weights (avmnist/run_training.py:109-128)
        test_restore_best=False,
        # flat epoch-end names too (val_loss / x1_val_acc / avg_test_acc,
        # joint_model.py:265-268, 312-316)
        legacy_metric_aliases=True,
    )
    # legacy plain SGD (avmnist/joint_model.py:340-342)
    return spec, {"momentum": 0.0, "weight_decay": 0.0}
