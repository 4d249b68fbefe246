"""AV-MNIST, MIMIC and MUsTARD files in the reference's layouts, made from
a seed: what ``get_data`` reads where the real dataset is present, for
the tests and ``chip_smoke.py``.  The per-sample geometry is the
published one; only the row counts are the caller's.

- AV-MNIST (avmnist/get_data.py:25-58), under a directory:
  ``image/{train,test}_data.npy`` (N, 784) and
  ``audio/{train,test}_data.npy`` (N, 112, 112), float32 pixel values
  0-255 (the loader divides by 255), and ``{train,test}_labels.npy`` (N,)
  int64 digits.  The first 55 000 train rows are the train split, the
  rest the val split.
- MIMIC (mimic/get_data.py:30-95), one pickle ``im.pk``: ``ep_tdata`` (N,
  24, 12) and ``adm_features_all`` (N, 5) float32 with inf and nan
  entries, ``adm_labels_all`` (N, 6) 0/1 (columns 1-5 the five mortality
  windows), ``y_icd9`` (N, 20) 0/1.
- MUsTARD (mustard/get_data.py), one pickle ``sarcasm.pkl``: ``train`` /
  ``valid`` / ``test``, each a dict of per-sample ``vision`` (L, 371),
  ``audio`` (L, 81) and ``text`` (L, 300) float32 sequences of lengths on
  both sides of 40, with one all-zero text row per split and a few
  non-finite entries, and ``labels`` (n, 1) float32 in {-1, 1}.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np

MUSTARD_FEATURES = {"vision": 371, "audio": 81, "text": 300}


def build_avmnist_tree(root: str, n_train: int, n_test: int,
                       seed: int = 0) -> Dict:
    """The six ``.npy`` files under ``root``; returns the row and byte
    counts."""
    rng = np.random.default_rng(seed)
    nbytes = 0
    for split, n in (("train", n_train), ("test", n_test)):
        arrays = {
            os.path.join("image", f"{split}_data.npy"): rng.integers(
                0, 256, (n, 784), dtype=np.uint8).astype(np.float32),
            os.path.join("audio", f"{split}_data.npy"): rng.integers(
                0, 256, (n, 112, 112), dtype=np.uint8).astype(np.float32),
            f"{split}_labels.npy": rng.integers(0, 10, n),
        }
        for name, arr in arrays.items():
            path = os.path.join(root, name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, arr)
            nbytes += arr.nbytes
    return {"rows": n_train + n_test, "bytes": nbytes}


def build_mimic_pickle(path: str, n: int, seed: int = 0) -> Dict:
    """``im.pk`` of ``n`` admissions at ``path``."""
    rng = np.random.default_rng(seed)
    tdata = rng.normal(2.0, 3.0, (n, 24, 12)).astype(np.float32)
    static = rng.normal(-1.0, 2.0, (n, 5)).astype(np.float32)
    for arr in (tdata, static):
        flat = arr.reshape(-1)
        picks = rng.choice(flat.size, 12, replace=False)
        flat[picks[:4]] = np.inf
        flat[picks[4:8]] = -np.inf
        flat[picks[8:]] = np.nan
    data = {
        "ep_tdata": tdata,
        "adm_features_all": static,
        "adm_labels_all": (rng.random((n, 6)) < 0.15).astype(np.int64),
        "y_icd9": (rng.random((n, 20)) < 0.4).astype(np.int64),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return {"rows": n, "bytes": os.path.getsize(path)}


def build_mustard_pickle(path: str, n_train: int, n_valid: int, n_test: int,
                         seed: int = 0) -> Dict:
    """``sarcasm.pkl`` with the three splits at ``path``; row 1 of each
    split has all-zero text, so ``get_data`` drops it."""
    rng = np.random.default_rng(seed)
    data = {}
    for split, n in (("train", n_train), ("valid", n_valid),
                     ("test", n_test)):
        lengths = rng.integers(20, 61, n)
        lengths[0], lengths[2] = 25, 55  # both sides of max_seq_len 40
        d = {name: [rng.normal(size=(length, dim)).astype(np.float32)
                    for length in lengths]
             for name, dim in MUSTARD_FEATURES.items()}
        d["text"][1][:] = 0.0
        d["vision"][0][0, :3] = (np.nan, np.inf, -np.inf)
        d["labels"] = rng.choice([-1.0, 1.0], (n, 1)).astype(np.float32)
        data[split] = d
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return {"rows": n_train + n_valid + n_test,
            "bytes": os.path.getsize(path)}
