"""Food101's legacy disk feed: raw JPEGs and recipe-title text (port of
``multimodal_clinical_tpu/data/food101_legacy.py``, numpy and PIL only).

The reference's MultimodalFoodDataset (food101/get_data_old.py):
``texts_{split}.csv`` rows of (image_name, text, food); images at
``images/{split}/{class-from-filename}/{image_name}``; the train
transform Resize((224, 224)) and RandomHorizontalFlip, eval a plain
Resize, both ImageNet-normalised (get_data_old.py:34-49); the text
cleaned by the same regex chain (get_data_old.py:93-101) and tokenized
with bert-base-uncased WordPiece from a local ``vocab.txt``
(``data/wordpiece.py``), or by a crc32 hash of each word without one.
Labels are sklearn ``LabelEncoder``'s: the sorted unique foods of the
train split (get_data_old.py:30-32).
"""

from __future__ import annotations

import csv
import os
import re
import zlib
from typing import Dict

import numpy as np

from .core import sample_rng
from .imageops import IMAGENET_MEAN, IMAGENET_STD, pil_resize_u8
from .wordpiece import load_tokenizer


def preprocess_text(text: str) -> str:
    """The reference's regex chain (get_data_old.py:93-101)."""
    text = re.sub(r"<[^>]+>", "", text)          # HTML tags
    text = re.sub("[^a-zA-Z]", " ", text)        # punctuation and digits
    text = re.sub(r"\s+[a-zA-Z]\s+", " ", text)  # single characters
    text = re.sub(r"\s+", " ", text)             # runs of spaces
    return text.lower()


def class_from_filename(filename: str) -> str:
    """apple_pie_0001.jpg -> apple_pie (get_data_old.py:85-88)."""
    return "_".join(filename.split("_")[:-1])


class Food101LegacyDiskDataset:
    """One split of the legacy corpus: x1 (n, 224, 224, 3) fp32 images,
    x2 (n, ``max_seq_len``) int32 ids padded with 0, the labels."""

    def __init__(self, data_dir: str, split: str, args):
        self.data_dir = data_dir
        self.split = split
        self.train = split == "train"
        self.max_len = int(getattr(args, "max_seq_len", 512))
        self.vocab_size = int(getattr(args, "legacy_bert_vocab", 30522))
        self._seed = int(getattr(args, "seed", 0))
        self._epoch = 0
        self._tokenizer = load_tokenizer(args)
        if self._tokenizer is None:
            print("[food101-legacy] no local vocab.txt; "
                  "crc32 hash tokenizer in use")

        def read_rows(name):
            with open(os.path.join(data_dir, name), newline="") as f:
                return [(r[0], r[1], r[2]) for r in csv.reader(f)
                        if len(r) >= 3]

        self.items = read_rows(f"texts_{split}.csv")
        # the label space of the TRAIN split for every split: a map per
        # split would renumber every class after one absent from a split
        train_rows = (self.items if self.train
                      else read_rows("texts_train.csv"))
        foods = sorted({food for _, _, food in train_rows})
        self._food2idx = {food: i for i, food in enumerate(foods)}
        unknown = ({food for _, _, food in self.items}
                   - self._food2idx.keys())
        if unknown:
            raise ValueError(
                f"texts_{split}.csv contains foods absent from "
                f"texts_train.csv: {sorted(unknown)[:5]} — the train split "
                f"defines the label space")
        self.labels = np.asarray(
            [self._food2idx[food] for _, _, food in self.items], np.int32)

    def __len__(self) -> int:
        return len(self.items)

    def _tokenize(self, text: str) -> np.ndarray:
        text = preprocess_text(text)
        if self._tokenizer is not None:
            return self._tokenizer.encode(text, self.max_len)
        ids = [(zlib.crc32(tok.encode()) % (self.vocab_size - 2)) + 2
               for tok in text.split()][: self.max_len]
        return np.asarray(ids + [0] * (self.max_len - len(ids)), np.int32)

    def set_epoch(self, epoch: int) -> None:
        """Flip draws per (seed, epoch, index) (``core.sample_rng``)."""
        self._epoch = int(epoch)

    def _load_image(self, name: str, rng) -> np.ndarray:
        path = os.path.join(self.data_dir, "images", self.split,
                            class_from_filename(name), name)
        # PIL: .convert("RGB").resize((224, 224), BILINEAR)
        out = pil_resize_u8(path, 224, 224).astype(np.float32) / 255.0
        if self.train and rng.random() < 0.5:
            out = out[:, ::-1]
        return ((out - np.asarray(IMAGENET_MEAN, np.float32))
                / np.asarray(IMAGENET_STD, np.float32)).astype(np.float32)

    def gather(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        imgs, toks = [], []
        for i in indices:
            name, text, _food = self.items[int(i)]
            imgs.append(self._load_image(
                name, sample_rng(self._seed, self._epoch, int(i))))
            toks.append(self._tokenize(text))
        return {
            "x1": np.stack(imgs),
            "x2": np.stack(toks),
            "label": self.labels[np.asarray(indices, np.int64)],
        }
