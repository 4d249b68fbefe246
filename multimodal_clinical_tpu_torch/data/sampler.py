"""Index samplers: sequential, shuffled, and class-balanced weighted (port
of ``multimodal_clinical_tpu/data/sampler.py``: the same stream per
(seed, epoch)).

The weighted sampler is the reference's inverse-frequency
``WeightedRandomSampler`` (cremad/get_data.py:153-158) rebuilt host-side:
weights are 1/class-count per sample, draws are with replacement, one
epoch draws ``len(labels)`` indices.  It draws from the alias table of
``native/libfastdata.so`` when that library loads (``utils/native.py``)
and from numpy otherwise, as the JAX sampler does: the two packages draw
the same stream when both see the library or neither does.

Every sampler derives one global per-epoch stream from ``(seed, epoch)``;
with ``process_count > 1`` it is wrap-padded to a multiple of the process
count and each process takes ``stream[process_index::process_count]``.
"""

from __future__ import annotations

import numpy as np

from ..utils import native


def _host_shard(stream: np.ndarray, process_index: int,
                process_count: int) -> np.ndarray:
    """Equal-length per-host shard of the global stream (wrap-padded)."""
    if process_count <= 1:
        return stream
    n = len(stream)
    total = -(-n // process_count) * process_count
    if total != n:
        stream = np.concatenate([stream, stream[: total - n]])
    return stream[process_index::process_count]


def _shard_len(n: int, process_count: int) -> int:
    return -(-n // process_count) if process_count > 1 else n


class SequentialSampler:
    """Deterministic 0..n-1 order (eval splits)."""

    def __init__(self, n: int, process_index: int = 0,
                 process_count: int = 1):
        self.n = int(n)
        self.process_index = int(process_index)
        self.process_count = int(process_count)

    def __len__(self) -> int:
        return _shard_len(self.n, self.process_count)

    def indices(self, epoch: int = 0) -> np.ndarray:
        return _host_shard(np.arange(self.n, dtype=np.int64),
                           self.process_index, self.process_count)


class RandomSampler:
    """Per-epoch deterministic permutation of 0..n-1."""

    def __init__(self, n: int, seed: int = 0, process_index: int = 0,
                 process_count: int = 1):
        self.n = int(n)
        self.seed = int(seed)
        self.process_index = int(process_index)
        self.process_count = int(process_count)

    def __len__(self) -> int:
        return _shard_len(self.n, self.process_count)

    def indices(self, epoch: int = 0) -> np.ndarray:
        rng = np.random.default_rng([self.seed, int(epoch), 103])
        perm = rng.permutation(self.n).astype(np.int64)
        return _host_shard(perm, self.process_index, self.process_count)


class WeightedSampler:
    """Inverse-class-frequency sampling with replacement
    (cremad/get_data.py:153-158 semantics)."""

    def __init__(self, labels: np.ndarray, seed: int = 0,
                 num_samples: int = 0, process_index: int = 0,
                 process_count: int = 1):
        labels = np.asarray(labels).astype(np.int64)
        counts = np.bincount(labels)
        # counts[labels[i]] >= 1 always (sample i counts itself)
        self.weights = 1.0 / counts[labels].astype(np.float64)
        self.n = int(num_samples) or len(labels)
        self.seed = int(seed)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self._alias = (native.AliasTable(self.weights)
                       if native.available() else None)

    def __len__(self) -> int:
        return _shard_len(self.n, self.process_count)

    def indices(self, epoch: int = 0) -> np.ndarray:
        if self._alias is not None:
            draw_seed = (self.seed * 1_000_003 + int(epoch)) & 0x7FFFFFFF
            stream = self._alias.sample(self.n, seed=draw_seed)
        else:
            rng = np.random.default_rng([self.seed, int(epoch), 211])
            p = self.weights / self.weights.sum()
            stream = rng.choice(len(self.weights), size=self.n,
                                replace=True, p=p)
        return _host_shard(np.asarray(stream, np.int64),
                           self.process_index, self.process_count)
