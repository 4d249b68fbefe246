"""MIMIC-III EHR: a static 5-dim vector and a 24 x 12 time series, 6-way
mortality or a binary ICD-9 task (port of
``multimodal_clinical_tpu/benchmarks/mimic.py``).

Data (reference mimic/get_data.py:30-95): the MultiBench ``im.pk``
pickle at ``data_path`` (``ep_tdata`` (N, 24, 12), ``adm_features_all``
(N, 5), ``adm_labels_all`` (N, >= 6), ``y_icd9`` (N, 20)); inf and nan
-> 0; both modalities z-scored; ``task_num`` -1 builds the 6-class
mortality label, else ``y_icd9[:, task_num]``; a ``random.Random(seed)``
shuffle splits 10% / 10% / 80% into val / test / train.  The reference
builds a balanced train sampler but passes neither it nor shuffle=True to
the DataLoader (mimic/run_training.py:39-46): train iterates the
shuffled order, the same every epoch.

Model types (mimic/__init__.py), all on ``MimicFusionNet``:
  jlogits   MLP(5 -> ... C) + GRU(12 -> 32), logit mean (joint_model.py);
  ensemble  the same nets, train loss and train metrics weighted 0.8 /
            1.5 (ensemble_model.py:157,160), the plain mean at val and
            test (ensemble_model.py:197-199, 234-239);
  jprobas   probability fusion under bare Adam (joint_model_proba.py:
            314-316);
  ogm_ge    OGM-GE: the MLP and the GRU have no 4-D parameter, so the
            modulation changes nothing (ogm_ge_model.py:192-193);
  qmf       the intended QMF (the reference's qmf_model.py does not run).
Every type but jprobas trains with SGD(0.9, 1e-4) (joint_model.py:257).
"""

from __future__ import annotations

import os
import pickle
import random
from typing import Dict, Tuple

import numpy as np

from ..data.core import ArrayDataset
from ..data.synthetic import make_synthetic_splits
from ..engine.run import DataBundle
from ..engine.spec import ModelSpec, resolve_dtype
from ..models.zoo import MimicFusionNet

MODEL_TYPES = ("jlogits", "ensemble", "jprobas", "ogm_ge", "qmf")


def _load_real(path: str, task: int, seed: int):
    with open(path, "rb") as f:
        datafile = pickle.load(f)
    x_t = np.asarray(datafile["ep_tdata"], np.float32)
    x_s = np.asarray(datafile["adm_features_all"], np.float32)
    x_t[~np.isfinite(x_t)] = 0
    x_s[~np.isfinite(x_s)] = 0
    x_s = (x_s - x_s.mean(0)) / x_s.std(0)
    x_t = (x_t - x_t.mean((0, 1))) / x_t.std((0, 1))

    if task < 0:
        adm = np.asarray(datafile["adm_labels_all"])
        # 6-way time-to-mortality (mimic/get_data.py:64-80)
        y = np.select(
            [adm[:, 1] > 0, adm[:, 2] > 0, adm[:, 3] > 0, adm[:, 4] > 0,
             adm[:, 5] > 0],
            [1, 2, 3, 4, 5],
            default=0)
    else:
        y = np.asarray(datafile["y_icd9"])[:, task]
    y = y.astype(np.int32)

    n = len(y)
    order = list(range(n))
    random.Random(seed).shuffle(order)  # the reference's random.shuffle
    order = np.asarray(order)

    def subset(idx):
        return ArrayDataset([x_s[idx], x_t[idx]], y[idx])

    return (subset(order[n // 5:]), subset(order[:n // 10]),
            subset(order[n // 10:n // 5]))


def get_data(args) -> DataBundle:
    path = getattr(args, "data_path", "data/mimic/im.pk")
    task = int(getattr(args, "task_num", -1))
    # isfile, not exists: data_path is the im.pk file itself; a directory
    # there means no real data
    if os.path.isfile(path):
        train, val, test = _load_real(path, task,
                                      int(getattr(args, "seed", 0)))
        synthetic = False
    else:
        print(f"[mimic] real data not found at {path!r}; using synthetic "
              "twin")
        train, val, test = make_synthetic_splits(
            "mimic", int(args.num_classes), int(getattr(args, "seed", 0)))
        synthetic = True
    return DataBundle(train, val, test, train_sampler="sequential",
                      synthetic=synthetic)


def get_model_spec(args, n_train: int) -> Tuple[ModelSpec, Dict]:
    model_type = getattr(args, "model_type", "jlogits")
    module = MimicFusionNet(int(args.num_classes), dtype=resolve_dtype(args))
    opt_kwargs: Dict = {}
    if model_type == "jlogits":
        spec = ModelSpec(module=module, contract="jlogits")
    elif model_type == "jprobas":
        spec = ModelSpec(module=module, contract="jprobas")
        opt_kwargs = {"optimizer": "adam"}
    elif model_type == "ensemble":
        spec = ModelSpec(module=module, contract="ensemble",
                         fusion_weights=(0.8, 1.5))
    elif model_type == "ogm_ge":
        spec = ModelSpec(module=module, contract="ogm_ge",
                         grad_mod_type=getattr(args, "grad_mod_type",
                                               "OGM_GE"),
                         ogm_alpha=float(getattr(args, "alpha", 0.1)))
    elif model_type == "qmf":
        spec = ModelSpec(module=module, contract="qmf",
                         n_train_samples=n_train)
    else:
        raise NotImplementedError(f"mimic model_type {model_type!r}")
    return spec, opt_kwargs
