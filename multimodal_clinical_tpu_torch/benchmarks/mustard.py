"""MUsTARD: sarcasm detection from three sequences, vision 371 / audio 81
/ text 300-d GloVe, binary (port of
``multimodal_clinical_tpu/benchmarks/mustard.py``).

Data (reference mustard/get_data.py): the MultiBench affect
``sarcasm.pkl`` at ``data_path``, a dict of ``train`` / ``valid`` /
``test``, each with per-sample ``vision``, ``audio``, ``text`` arrays of
(length, features) and ``labels``; samples whose text is all zero are
dropped (drop_entry, get_data.py:268-270); sequences end-padded or cut to
``max_seq_len`` (40); non-finite values -> 0; no z-normalisation (the
reference's default).  The reference flags this benchmark as unstable
(mustard/ERROR.md), which ``get_data`` prints.

Model: three LstmClassifiers, under jlogits (mustard/joint_model.py:
45-83) or the repository's ensemble, with bare Adam and fp32 compute
(configs/mustard.yaml).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Tuple

import numpy as np

from ..data.core import ArrayDataset
from ..data.synthetic import make_synthetic_splits
from ..engine.run import DataBundle
from ..engine.spec import ModelSpec, resolve_dtype
from ..models.zoo import MustardFusionNet

MODEL_TYPES = ("jlogits", "ensemble")


def _pad_seq(x: np.ndarray, max_len: int) -> np.ndarray:
    """Cut or end-pad to ``max_len`` with zeros, as the reference's
    F.pad at the end (mustard/get_data.py:189-198, 238-241)."""
    if len(x) >= max_len:
        return x[:max_len]
    return np.concatenate(
        [x, np.zeros((max_len - len(x),) + x.shape[1:], x.dtype)])


def _load_real(path: str, max_seq_len: int):
    with open(path, "rb") as f:
        data = pickle.load(f)

    def build(split):
        d = data[split]
        keep = [i for i, t in enumerate(d["text"])
                if np.abs(np.asarray(t)).sum() > 0]
        mods = [np.stack([_pad_seq(np.asarray(d[name][i], np.float32),
                                   max_seq_len) for i in keep])
                for name in ("vision", "audio", "text")]
        labels = (np.asarray(d["labels"])[keep].reshape(len(keep), -1)[:, 0]
                  > 0).astype(np.int32)
        for arr in mods:
            arr[~np.isfinite(arr)] = 0
        return ArrayDataset(mods, labels)

    return build("train"), build("valid"), build("test")


def get_data(args) -> DataBundle:
    path = getattr(args, "data_path", "data/mustard/sarcasm.pkl")
    max_seq_len = int(getattr(args, "max_seq_len", 40))
    # isfile, not exists: data_path is the sarcasm.pkl file itself
    if os.path.isfile(path):
        print("[mustard] note: reference flags this benchmark as unstable "
              "(mustard/ERROR.md)")
        train, val, test = _load_real(path, max_seq_len)
        synthetic = False
    else:
        print(f"[mustard] real data not found at {path!r}; "
              "using synthetic twin")
        train, val, test = make_synthetic_splits(
            "mustard", int(args.num_classes), int(getattr(args, "seed", 0)),
            n_train=64, n_val=32, n_test=32)
        synthetic = True
    # sequential train order every epoch (mustard/run_training.py:73-80)
    return DataBundle(train, val, test, train_sampler="sequential",
                      synthetic=synthetic)


def get_model_spec(args, n_train: int) -> Tuple[ModelSpec, Dict]:
    model_type = getattr(args, "model_type", "jlogits")
    if model_type not in MODEL_TYPES:
        raise NotImplementedError(f"mustard model_type {model_type!r}")
    module = MustardFusionNet(int(args.num_classes), dtype=resolve_dtype(args))
    # the legacy runner: no ModelCheckpoint, the test epoch on the final
    # weights (mustard/run_training.py:100-135); flat epoch-end names, x3
    # included (joint_model.py:197-201, 264-268)
    spec = ModelSpec(module=module, contract=model_type, num_modality=3,
                     test_restore_best=False, legacy_metric_aliases=True)
    # bare Adam(args.lr), no scheduler (mustard/joint_model.py:275-277)
    return spec, {"optimizer": "adam"}
