"""In-memory dataset over parallel modality arrays (port of
``multimodal_clinical_tpu/data/core.py``, numpy only).

The reference's in-memory datasets are lists of per-sample tuples pulled
item-by-item through DataLoader workers (avmnist/get_data.py:25-58,
mimic/get_data.py:84-95).  Here the natural unit is the *batch*: datasets
expose ``gather(indices) -> {"x1": ..., "x2": ..., "label": ...}`` so one
vectorized numpy take feeds the whole fixed-shape device batch — no
per-item Python loop, no collate step.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


class ArrayDataset:
    """Parallel modality arrays + labels; ``gather`` is a vectorized take.

    ``modalities`` is a list of arrays with a shared leading sample axis;
    subclasses may override ``gather`` to rename keys (e.g. the raw-waveform
    ``x1_waveform`` path in benchmarks/vggsound.py).
    """

    def __init__(self, modalities: Sequence[np.ndarray], labels: np.ndarray):
        self.modalities: List[np.ndarray] = [np.asarray(m) for m in modalities]
        self.labels = np.asarray(labels)
        for m in self.modalities:
            if len(m) != len(self.labels):
                raise ValueError(
                    f"modality length {len(m)} != labels {len(self.labels)}")

    def __len__(self) -> int:
        return len(self.labels)

    def gather(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        idx = np.asarray(indices)
        out = {f"x{i + 1}": m[idx] for i, m in enumerate(self.modalities)}
        out["label"] = self.labels[idx]
        return out


def sample_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    """Stateless per-(seed, epoch, index) Generator for host-side
    augmentation draws (random crop/flip/frame choice).

    The reference's torch DataLoader draws from per-worker global streams,
    so its augmentations depend on the worker schedule.  Deriving a fresh
    SeedSequence per sample makes every draw reproducible under ANY loader
    ``workers`` split and lets disk gathers run thread-parallel.
    """
    return np.random.default_rng(
        (int(seed) & 0x7FFFFFFF, int(epoch) & 0x7FFFFFFF,
         int(index) & 0x7FFFFFFF))
