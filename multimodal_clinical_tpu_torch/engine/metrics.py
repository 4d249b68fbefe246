"""Epoch-level metric aggregation with the reference's naming contract
(port of ``multimodal_clinical_tpu/engine/metrics.py``).

Metric names are the public API for parity checking: ``train_step/*``,
``train_epoch/train_avg_*``, ``val_epoch/val_avg_*``,
``test_epoch/test_avg_*``, including the reference's quirk that step-level
uncalibrated accuracy is ``train_x1_uncal_acc`` while the epoch level is
``train_avg_x1_acc_uncal`` (BaseModel.py:99 vs 124).

Per-step values stay on the device; ``EpochAccumulator.summary`` fetches
each metric's stream once, at epoch end.  The summaries then run the JAX
package's numpy arithmetic on the host copies.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .contracts import offset_correct

_STEP_NAME_FIXUPS = {
    # step-level logging uses *_uncal_acc (BaseModel.py:99-100)
    "train_x1_acc_uncal": "train_x1_uncal_acc",
    "train_x2_acc_uncal": "train_x2_uncal_acc",
    "train_x3_acc_uncal": "train_x3_uncal_acc",
}


def step_metric_name(prefix: str, key: str) -> str:
    return f"{prefix}_step/{_STEP_NAME_FIXUPS.get(key, key)}"


def to_host(value) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class EpochAccumulator:
    """Accumulates per-step metric dicts; one device->host fetch per metric
    per epoch."""

    def __init__(self) -> None:
        self._buffers: Dict[str, List] = {}

    def append(self, metrics: Dict) -> None:
        for key, value in metrics.items():
            self._buffers.setdefault(key, []).append(value)

    def summary(self) -> Dict[str, float]:
        out = {}
        for key, values in self._buffers.items():
            # K-step dispatches append (K,)-shaped metric vectors while
            # single steps append scalars; flatten both into one stream,
            # fetched at once
            arr = to_host(torch.cat([torch.as_tensor(v).reshape(-1)
                                     for v in values]))
            if key == "valid_count" or key.startswith("count_"):
                out[key] = float(arr.sum())
            else:
                out[key] = float(arr.mean())
        return out


def train_epoch_summary(acc: EpochAccumulator) -> Dict[str, float]:
    """train_epoch/train_avg_<metric> means (BaseModel.py:115-134)."""
    raw = acc.summary()
    out = {}
    for key, value in raw.items():
        if key == "valid_count":
            continue
        if key.startswith("count_"):
            # min-loss counters: train_epoch/joint_count etc.
            # (enrico/joint_model_counts.py:128-131)
            out[f"train_epoch/{key[len('count_'):]}_count"] = value
            continue
        name = key[len("train_"):]
        out[f"train_epoch/train_avg_{name}"] = value
    return out


def legacy_alias_summary(summary: Dict[str, float], prefix: str
                         ) -> Dict[str, float]:
    """Flat epoch-end metric names of the LEGACY standalone dirs
    (avmnist/ave/vggsound/mustard): ``val_loss``/``val_acc``/
    ``x{i}_val_acc`` and ``test_loss``/``avg_test_loss``/``test_acc``/
    ``avg_test_acc``/``x{i}_test_acc`` (avmnist/joint_model.py:265-268,
    mustard/joint_model.py:264-268, vggsound/ensemble_model.py:229-232).
    Emitted ALONGSIDE the namespaced keys, never instead of them."""
    out: Dict[str, float] = {}
    loss = summary.get(f"{prefix}_epoch/{prefix}_avg_loss")
    acc = summary.get(f"{prefix}_epoch/{prefix}_avg_acc")
    if loss is not None:
        out[f"{prefix}_loss"] = loss
        if prefix == "test":
            out["avg_test_loss"] = loss
    if acc is not None:
        out[f"{prefix}_acc"] = acc
        if prefix == "test":
            out["avg_test_acc"] = acc
    i = 1
    while f"{prefix}_epoch/{prefix}_avg_x{i}_acc" in summary:
        out[f"x{i}_{prefix}_acc"] = summary[
            f"{prefix}_epoch/{prefix}_avg_x{i}_acc"]
        i += 1
    return out


def eval_epoch_summary(
    outputs: List[Dict],
    prefix: str,
    with_offset_correction: bool = True,
) -> Dict[str, float]:
    """Aggregate eval-step outputs (tensors or numpy arrays) into the epoch
    namespace.

    Implements the full-epoch unimodal offset correction over the
    concatenated (N, M, C) logits (BaseModel.py:168-202), with padding rows
    from fixed-shape batches removed before the correction.
    """
    avg_loss = float(np.mean([to_host(o["loss"]) for o in outputs]))
    avg_acc = float(np.mean([to_host(o["acc"]) for o in outputs]))
    summary = {
        f"{prefix}_epoch/{prefix}_avg_acc": avg_acc,
        f"{prefix}_epoch/{prefix}_avg_loss": avg_loss,
    }

    if "df_acc" in outputs[0]:
        summary[f"{prefix}_epoch/{prefix}_avg_df_acc"] = float(
            np.mean([to_host(o["df_acc"]) for o in outputs]))

    for key in outputs[0]:
        if key.startswith("count_"):
            summary[f"{prefix}_epoch/{key[len('count_'):]}_count"] = float(
                np.sum([to_host(o[key]) for o in outputs]))

    if "x1_acc" in outputs[0]:
        # ensemble contract: per-modality step means, no offset correction
        i = 1
        while f"x{i}_acc" in outputs[0]:
            summary[f"{prefix}_epoch/{prefix}_avg_x{i}_acc"] = float(
                np.mean([to_host(o[f"x{i}_acc"]) for o in outputs]))
            i += 1
        return summary

    if not with_offset_correction:
        return summary

    logits = np.concatenate([to_host(o["logits_stack"]) for o in outputs])
    labels = np.concatenate([to_host(o["label"]) for o in outputs])
    valid = np.concatenate(
        [to_host(o["valid"]).astype(bool) for o in outputs])
    logits, labels = logits[valid], labels[valid]
    corrected = offset_correct(torch.from_numpy(logits)).numpy()

    num_modality = logits.shape[1]
    for i in range(num_modality):
        uncal = float(np.mean(np.argmax(logits[:, i, :], axis=-1) == labels))
        cal = float(np.mean(np.argmax(corrected[:, i, :], axis=-1) == labels))
        summary[f"{prefix}_epoch/{prefix}_avg_x{i + 1}_acc_uncal"] = uncal
        summary[f"{prefix}_epoch/{prefix}_avg_x{i + 1}_acc"] = cal
    return summary
