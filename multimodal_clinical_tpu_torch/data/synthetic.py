"""Synthetic twins: planted-signal stand-ins for every benchmark's data
(port of ``multimodal_clinical_tpu/data/synthetic.py``, numpy only, the
same draws).

The reference has no test data and no tests; its datasets need hundreds
of GB on disk.  Every benchmark adapter falls back to a synthetic twin with
the same modality shapes and dtypes, so the full train/eval stack runs
anywhere, and the twins carry a *planted linear signal* (a fixed per-class
direction added to noise), so "the loss goes down and accuracy beats
chance" is a meaningful assertion, as the reference's overfit-batches
sanity runs are (utils/run_trainer.py:54).

Token modalities draw ids from a tiny range far below every model's vocab,
so no embedding gather reads out of range.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .core import ArrayDataset

# Default modality shapes per benchmark — the real-data geometry for the
# light benchmarks; CPU-test-friendly reductions for the heavyweight token
# twins (fakenews / food101_legacy), where only shape *structure* matters.
BENCHMARK_SHAPES: Dict[str, List[Tuple[int, ...]]] = {
    "avmnist": [(28, 28, 1), (112, 112, 1)],          # avmnist/get_data.py:25-58
    "mimic": [(5,), (24, 12)],                        # mimic/get_data.py:46-59
    "cremad": [(257, 1004, 1), (3, 224, 224, 3)],     # cremad/get_data.py:120-127
    "ave": [(257, 1004, 1), (6, 224, 224, 3)],        # ave/get_data.py:135
    "vggsound": [(129, 626, 1), (4, 224, 224, 3)],    # vggsound/get_data.py:106-158
    "enrico": [(256, 128, 3), (256, 128, 3)],         # enrico/get_data.py:94-103
    "mustard": [(40, 371), (40, 81), (40, 300)],      # mustard.yaml max_seq_len
    "food101": [(64,), (224, 224, 3)],                # food101/extract_token.py
    "food101_legacy": [(64, 64, 3), (32,)],           # get_data_old.py (shrunk)
    "fakenews": [(32,), (64, 64, 3)],                 # fakenews/get_data.py (shrunk)
    "fakenews_dialogue": [(32,), (64, 64, 3), (32,)],
    # precomputed sentence-transformer embeddings + image
    # (fakenews/model.py:27 SENTENCE_TRANSFORMER_EMBEDDING_DIM; image shrunk)
    "fakenews_embed": [(768,), (64, 64, 3)],
    "fakenews_embed_dialogue": [(768,), (64, 64, 3), (768,)],
}

# Which modality indices are int token ids (everything else is float).
TOKEN_MODALITIES: Dict[str, Tuple[int, ...]] = {
    "food101": (0,),
    "food101_legacy": (1,),
    "fakenews": (0,),
    "fakenews_dialogue": (0, 2),
}

# Every model vocab in the zoo is >= 200 (test shrink) and real ones are
# 30k/32k; ids stay far below all of them.
SYNTH_VOCAB = 100
NOISE_SCALE = 0.5  # SNR 2:1 against unit-normal class directions


def make_synthetic_dataset(name: str, n: int, num_classes: int, *,
                           seed: int = 0, dirs_seed: int = 0,
                           shapes: Optional[Sequence[Tuple[int, ...]]] = None
                           ) -> ArrayDataset:
    """One split of planted-signal data.

    ``dirs_seed`` fixes the per-class signal directions; splits that share
    it (train/val/test of one run) share the signal, so training on the
    train split genuinely transfers to eval — while ``seed`` varies the
    noise and label order per split.
    """
    shapes = list(shapes) if shapes is not None else BENCHMARK_SHAPES[name]
    token_mods = TOKEN_MODALITIES.get(name, ())
    rng = np.random.default_rng([seed, 9021])
    # deterministic class coverage (weighted samplers need every class)
    labels = rng.permutation(np.arange(n) % num_classes).astype(np.int32)
    modalities: List[np.ndarray] = []
    for mi, shape in enumerate(shapes):
        if mi in token_mods:
            ids = rng.integers(2, SYNTH_VOCAB, size=(n,) + tuple(shape))
            # plant the signal: the first tokens encode the class
            # positions (0, 1) hold the class in base (SYNTH_VOCAB - 2):
            # the digit pair is unique per class up to 98^2 classes (a
            # multiplicative second position collided for classes 98 apart)
            ids[:, 0] = 2 + labels % (SYNTH_VOCAB - 2)
            if shape[0] > 1:
                ids[:, 1] = 2 + (labels // (SYNTH_VOCAB - 2)) % (
                    SYNTH_VOCAB - 2)
            modalities.append(ids.astype(np.int32))
        else:
            dirs_rng = np.random.default_rng([dirs_seed, 577, mi])
            dirs = dirs_rng.normal(size=(num_classes,) + tuple(shape))
            noise = rng.normal(scale=NOISE_SCALE, size=(n,) + tuple(shape))
            modalities.append((dirs[labels] + noise).astype(np.float32))
    return ArrayDataset(modalities, labels)


def make_synthetic_splits(name: str, num_classes: int, seed: int = 0,
                          n_train: int = 128, n_val: int = 64,
                          n_test: int = 64,
                          shapes: Optional[Sequence[Tuple[int, ...]]] = None
                          ) -> Tuple[ArrayDataset, ArrayDataset, ArrayDataset]:
    """(train, val, test) twins sharing one planted signal."""
    return tuple(
        make_synthetic_dataset(name, n, num_classes, seed=seed * 3 + k,
                               dirs_seed=seed, shapes=shapes)
        for k, n in enumerate((n_train, n_val, n_test))
    )
