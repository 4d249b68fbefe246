"""Fakeddit: post text and image, 6-way fake-news classification (port of
``multimodal_clinical_tpu/benchmarks/fakenews.py``).

The reference left this benchmark broken (fakenews/run_training.py:42-44
imports a ``joint_model`` that does not exist); the JAX package completes
its design in the late-fusion style, and so does the port:

  * the token variants (``jlogits``, ``ensemble``, and ``*_dialogue``
    with a third tower over summarised comments): ``FakeNewsFusionNet``,
    a text transformer over tokenised ids and a scratch ResNet18 over
    224 x 224 images.  Data: ``<data_path>/{train,validate,test}.tsv``
    (``id``, ``clean_title``, ``6_way_label``) with
    ``images/<id>.jpg``; rows without an image are dropped.  The text is
    tokenised by WordPiece over a local ``vocab.txt`` (``bert_vocab_path``
    or ``<data_path>/vocab.txt``), else SentencePiece over a local
    ``tokenizer.model``, else HF ``BertTokenizerFast`` from local files,
    else crc32 hash buckets; images resized by PIL's default resample and
    scaled to [0, 1].  The dialogue variants train on the synthetic twin
    (the TSVs carry no summarised dialogue).
  * the embed variants (``jlogits_embed[_dialogue]``), the reference's one
    runnable model (fakenews/model.py): ``FakeNewsEmbedFusionNet`` over
    precomputed 768-d sentence embeddings and a ResNet152, from the
    dataframe pickles ``<data_path>/{split}__text_image[_dialogue]_
    dataframe.pkl`` (or ``preprocessed_{split}_dataframe_path``) with
    ``images/<id>.jpg``, ImageNet-normalised.  ResNet152 weights come from
    a local torchvision checkpoint (``resnet152_weights``).

Every variant trains with bare Adam at the reference's module-scope 1e-4
whatever ``learning_rate`` says (fakenews/model.py:18,230), on the
sequential sampler, and tests the final weights.
"""

from __future__ import annotations

import csv
import os
import pickle
import zlib
from typing import Dict, Tuple

import numpy as np
import torch

from ..data.imageops import IMAGENET_MEAN, IMAGENET_STD, pil_resize_u8
from ..data.spm import load_spm
from ..data.synthetic import make_synthetic_splits
from ..data.wordpiece import load_tokenizer
from ..engine.run import DataBundle
from ..engine.spec import ModelSpec, resolve_dtype
from ..models.pretrained import torch_state_dict
from ..models.zoo import FakeNewsEmbedFusionNet, FakeNewsFusionNet

MODEL_TYPES = ("jlogits", "ensemble", "jlogits_dialogue",
               "ensemble_dialogue", "jlogits_embed",
               "jlogits_embed_dialogue")
# the reference's module-scope Adam rate (fakenews/model.py:18)
LEARNING_RATE = 1.0e-4


def _hash_tokenize(text: str, max_len: int, vocab: int) -> np.ndarray:
    """Stable hash-bucket tokenizer: crc32, not Python's salted ``hash``,
    so the vocabulary survives restarts and resumes."""
    ids = [(zlib.crc32(tok.encode()) % (vocab - 2)) + 2
           for tok in text.lower().split()]
    ids = ids[:max_len]
    return np.asarray(ids + [0] * (max_len - len(ids)), np.int32)


class FakeNewsDiskDataset:
    """One TSV split of the token variants; ``tokenizer`` says which of
    the four tokenizers it picked."""

    def __init__(self, data_dir: str, tsv: str, max_len: int, vocab: int,
                 args=None):
        self.data_dir = data_dir
        self.max_len = max_len
        self.vocab = vocab
        self.items = []
        with open(os.path.join(data_dir, tsv)) as f:
            for row in csv.DictReader(f, delimiter="\t"):
                img = os.path.join(data_dir, "images", row["id"] + ".jpg")
                if os.path.exists(img):
                    self.items.append((row.get("clean_title", ""), img,
                                       int(row["6_way_label"])))
        self.labels = np.asarray([l for _, _, l in self.items], np.int32)
        args_ns = (args if args is not None
                   else type("A", (), {"data_path": data_dir})())
        self._hf = self._spm = None
        self._wordpiece = load_tokenizer(args_ns)
        if self._wordpiece is None:
            self._spm = load_spm(args_ns)
        if self._wordpiece is None and self._spm is None:
            try:
                from transformers import BertTokenizerFast

                self._hf = BertTokenizerFast.from_pretrained(
                    "bert-base-uncased", local_files_only=True)
            except Exception:
                print("[fakenews] no vocab.txt/tokenizer.model and HF "
                      "tokenizer unavailable; hash tokenizer in use")
        self.tokenizer = ("wordpiece" if self._wordpiece is not None
                          else "sentencepiece" if self._spm is not None
                          else "hf" if self._hf is not None else "hash")

    def __len__(self):
        return len(self.items)

    def _tokens(self, text: str) -> np.ndarray:
        if self._wordpiece is not None:
            return self._wordpiece.encode(text, self.max_len)
        if self._spm is not None:
            ids = self._spm.encode(text)[: self.max_len]
            ids = ids + [max(self._spm.pad_id, 0)] * (self.max_len - len(ids))
            return np.asarray(ids, np.int32)
        if self._hf is not None:
            enc = self._hf(text, max_length=self.max_len, truncation=True,
                           padding="max_length")
            return np.asarray(enc["input_ids"], np.int32)
        return _hash_tokenize(text, self.max_len, self.vocab)

    def gather(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        toks, imgs, labels = [], [], []
        for i in indices:
            text, img_path, label = self.items[int(i)]
            toks.append(self._tokens(text))
            img = pil_resize_u8(img_path, 224, 224, bilinear=False)
            imgs.append(img.astype(np.float32) / 255.0)
            labels.append(label)
        return {"x1": np.stack(toks), "x2": np.stack(imgs),
                "label": np.asarray(labels, np.int32)}


_IMAGENET_MEAN = np.asarray(IMAGENET_MEAN, np.float32)
_IMAGENET_STD = np.asarray(IMAGENET_STD, np.float32)


class FakeNewsEmbedDataset:
    """The embed variants' split: the dict pickle ``tools/preprocess.py
    fakenews-embed`` writes ({"id", "embedding", "label"[,
    "dialogue_embedding"]}) and ``<data_dir>/images/<id>.jpg`` resized to
    ``image_dim``, scaled to [0, 1] and ImageNet-normalised (fakenews/
    model.py:77-87); rows whose image is missing are dropped."""

    def __init__(self, data_dir: str, pickle_path: str,
                 with_dialogue: bool, image_dim: int = 224):
        with open(pickle_path, "rb") as f:
            frame = pickle.load(f)
        self.data_dir = data_dir
        self.image_dim = image_dim
        if with_dialogue and "dialogue_embedding" not in frame:
            raise ValueError(
                f"{pickle_path} has no 'dialogue_embedding' — rerun "
                "tools/preprocess.py fakenews-embed --dialogue")
        self.items = []
        for i, sid in enumerate(frame["id"]):
            img = os.path.join(data_dir, "images", str(sid) + ".jpg")
            if os.path.exists(img):
                self.items.append((i, img))
        keep = [i for i, _ in self.items]
        self.embeddings = np.asarray(frame["embedding"], np.float32)[keep]
        self.dialogue = (np.asarray(frame["dialogue_embedding"],
                                    np.float32)[keep]
                         if with_dialogue else None)
        self.labels = np.asarray(frame["label"], np.int32)[keep]

    def __len__(self):
        return len(self.items)

    def gather(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        imgs = []
        for i in indices:
            arr = pil_resize_u8(self.items[int(i)][1], self.image_dim,
                                self.image_dim, bilinear=False)
            arr = arr.astype(np.float32) / 255.0
            imgs.append((arr - _IMAGENET_MEAN) / _IMAGENET_STD)
        out = {"x1": self.embeddings[indices], "x2": np.stack(imgs),
               "label": self.labels[indices]}
        if self.dialogue is not None:
            out["x3"] = self.dialogue[indices]
        return out


def get_data(args) -> DataBundle:
    data_dir = getattr(args, "data_path", "data/fakenews/")
    model_type = str(getattr(args, "model_type", ""))
    if "_embed" in model_type:
        return _get_embed_data(args, data_dir)
    max_len = int(getattr(args, "max_seq_len", 128))
    vocab = int(getattr(args, "vocab_size", 30522))
    with_dialogue = model_type.endswith("_dialogue")
    train_tsv = os.path.join(data_dir, "train.tsv")
    if os.path.exists(train_tsv) and not with_dialogue:
        train, val, test = (
            FakeNewsDiskDataset(data_dir, tsv, max_len, vocab, args)
            for tsv in ("train.tsv", "validate.tsv", "test.tsv"))
        print(f"[fakenews] {train.tokenizer} tokenizer")
        synthetic = False
    else:
        if with_dialogue and os.path.exists(train_tsv):
            print("[fakenews] dialogue variant needs a summarized-dialogue "
                  "column; using synthetic twin (see docs/DATASETS.md)")
        else:
            print(f"[fakenews] real data not found under {data_dir!r}; "
                  "using synthetic twin")
        train, val, test = make_synthetic_splits(
            "fakenews_dialogue" if with_dialogue else "fakenews",
            int(args.num_classes), int(getattr(args, "seed", 0)),
            n_train=64, n_val=32, n_test=32)
        synthetic = True
    # the reference's loaders pass no sampler and no shuffle
    # (fakenews/run_training.py:63-70): sequential every epoch
    return DataBundle(train, val, test, train_sampler="sequential",
                      synthetic=synthetic)


def _get_embed_data(args, data_dir: str) -> DataBundle:
    with_dialogue = str(getattr(args, "model_type", "")).endswith("_dialogue")
    infix = "text_image_dialogue" if with_dialogue else "text_image"
    paths = {}
    for split in ("train", "val", "test"):
        p = getattr(args, f"preprocessed_{split}_dataframe_path", None)
        paths[split] = p or os.path.join(
            data_dir, f"{split}__{infix}_dataframe.pkl")
    if all(os.path.exists(p) for p in paths.values()):
        splits = [FakeNewsEmbedDataset(data_dir, paths[s], with_dialogue)
                  for s in ("train", "val", "test")]
        synthetic = False
    else:
        missing = [p for p in paths.values() if not os.path.exists(p)]
        print(f"[fakenews] embed dataframes not found ({missing[0]}, ...); "
              "using synthetic twin")
        splits = make_synthetic_splits(
            "fakenews_embed_dialogue" if with_dialogue else "fakenews_embed",
            int(args.num_classes), int(getattr(args, "seed", 0)),
            n_train=64, n_val=32, n_test=32)
        synthetic = True
    return DataBundle(*splits, train_sampler="sequential",
                      synthetic=synthetic)


def load_pretrained(args, state):
    """The embed variants' image tower from a local torchvision resnet152
    checkpoint (``resnet152_weights``; the reference builds it with
    ``torchvision.models.resnet152(pretrained=True)``,
    fakenews/model.py:238), in place.  A no-op when unset."""
    ckpt = getattr(args, "resnet152_weights", None)
    if not ckpt:
        return state
    tower = getattr(state.model, "image_module", None)
    if tower is None:
        raise ValueError(
            "resnet152_weights applies to the jlogits_embed[_dialogue] "
            "variants only (current model_type="
            f"{getattr(args, 'model_type', '?')!r})")
    sd = torch_state_dict(ckpt)
    # torchvision's fc and num_batches_tracked have no place here
    tower.load_state_dict({k: torch.as_tensor(np.asarray(sd[k]))
                           for k in tower.state_dict()})
    print(f"[fakenews] loaded resnet152 tower from {ckpt}")
    return state


def get_model_spec(args, n_train: int) -> Tuple[ModelSpec, Dict]:
    model_type = getattr(args, "model_type", "jlogits")
    with_dialogue = model_type.endswith("_dialogue")
    # the legacy standalone runner: no ModelCheckpoint, the test epoch on
    # the final weights, flat epoch-end names (fakenews/model.py:207-226)
    common = dict(test_restore_best=False, legacy_metric_aliases=True)
    # bare Adam at the module-scope rate, whatever learning_rate says;
    # no scheduler (fakenews.yaml)
    opt = {"optimizer": "adam", "lr_override": LEARNING_RATE}
    if "_embed" in model_type:
        module = FakeNewsEmbedFusionNet(
            num_classes=int(args.num_classes),
            embedding_dim=int(getattr(args, "text_embed_dim", 768)),
            with_dialogue=with_dialogue,
            image_stage_sizes=tuple(getattr(args, "embed_stage_sizes",
                                            (3, 8, 36, 3))),
            dropout_p=float(getattr(args, "dropout_p", 0.1)),
            dtype=resolve_dtype(args))
        # one fused head: jlogits over a single "modality"
        return ModelSpec(module=module, contract="jlogits", num_modality=1,
                         num_inputs=3 if with_dialogue else 2,
                         **common), opt
    base = model_type.replace("_dialogue", "")
    if base not in ("jlogits", "ensemble"):
        raise NotImplementedError(f"fakenews model_type {model_type!r}")
    module = FakeNewsFusionNet(
        num_classes=int(args.num_classes),
        vocab_size=int(getattr(args, "vocab_size", 30522)),
        with_dialogue=with_dialogue, dtype=resolve_dtype(args))
    return ModelSpec(module=module, contract=base,
                     num_modality=3 if with_dialogue else 2, **common), opt
