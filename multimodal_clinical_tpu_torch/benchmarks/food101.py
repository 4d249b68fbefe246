"""UPMC Food-101: recipe text and food image, 101-way, on the SigLIP dual
tower (port of ``multimodal_clinical_tpu/benchmarks/food101.py``).

Data (reference food101/get_data.py:101-117): per sample, the SigLIP
processor's ``input_ids`` (64 tokens) and ``pixel_values`` (224 x 224,
stored CHW, some as (1, 3, H, W)) as ``.npy`` files under
``<data_path>/tokens/<stem>_{input_ids,pixel_values}.npy``, listed with
their labels by ``my_{train,dev,test}_food.txt``; the pixels are turned
into HWC here.  Without the lists, the synthetic twin.

Model types (food101/__init__.py):
  jlogits / ensemble: the SigLIP towers fully trainable with two MLP
      heads (768 -> 512 -> 512 -> C, dropout 0.2), StepLR(50, 0.5)
      (food101/joint_model.py:83);
  ogm_ge: the heads are ``x1_model``/``x2_model`` and hold no 4-D
      parameter, so the modulation is the reference's no-op
      (food101/joint_model_ogm_ge.py);
  qmf: the QMF loss over the two heads' logits (food101/joint_model_qmf.py);
  jprobas / jprobas_jlogits: the legacy frozen ResNet50 and frozen BERT
      towers (food101/joint_model_proba.py, joint_model_proba_logits.py:
      30-90), x1 the (B, 224, 224, 3) image and x2 the bert-base token
      ids, StepLR(500, 0.75); their data are ``texts_{train,test}.csv``
      and the JPEGs (``data/food101_legacy.py``), val and test both the
      test split, and their weights come from local torchvision and HF
      checkpoints (``resnet50_weights``, ``bert_weights``), random
      otherwise.

The train split is read in list order every epoch: the reference's train
DataLoader passes neither a sampler nor shuffle (food101/run_training.py:
39-45).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from ..data.synthetic import make_synthetic_splits
from ..engine.run import DataBundle
from ..engine.spec import ModelSpec, resolve_dtype
from ..models.bert import load_hf_bert_params
from ..models.pretrained import copy_by_name, torch_state_dict
from ..models.siglip import load_hf_siglip_params
from ..models.zoo import Food101FusionNet, Food101LegacyFusionNet

MODEL_TYPES = ("jlogits", "ensemble", "ogm_ge", "qmf", "jprobas",
               "jprobas_jlogits")
LEGACY_TYPES = ("jprobas", "jprobas_jlogits")


class Food101DiskDataset:
    """Per-sample ``.npy`` token ids and pixels, read at gather time."""

    def __init__(self, data_dir: str, split_file: str):
        self.data_dir = data_dir
        self.items = []
        with open(os.path.join(data_dir, split_file)) as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) >= 2:
                    self.items.append((parts[0], int(parts[1])))
        self.labels = np.asarray([l for _, l in self.items], np.int32)

    def __len__(self):
        return len(self.items)

    def gather(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        toks, pixels, labels = [], [], []
        for i in indices:
            name, label = self.items[int(i)]
            stem = os.path.join(self.data_dir, "tokens", os.path.splitext(
                os.path.basename(name))[0])
            toks.append(np.load(stem + "_input_ids.npy"))
            px = np.load(stem + "_pixel_values.npy")
            if px.ndim == 4:
                px = px[0]
            pixels.append(px.transpose(1, 2, 0))  # CHW -> HWC
            labels.append(label)
        return {
            "x1": np.stack(toks).astype(np.int32).reshape(len(indices), -1),
            "x2": np.stack(pixels).astype(np.float32),
            "label": np.asarray(labels, np.int32),
        }


def get_data(args) -> DataBundle:
    data_dir = getattr(args, "data_path", "data/food101/")
    if getattr(args, "model_type", "qmf") in LEGACY_TYPES:
        return _get_legacy_data(args, data_dir)
    if os.path.exists(os.path.join(data_dir, "my_train_food.txt")):
        train, val, test = (Food101DiskDataset(data_dir, f"my_{s}_food.txt")
                            for s in ("train", "dev", "test"))
        synthetic = False
    else:
        print(f"[food101] real data not found under {data_dir!r}; "
              "using synthetic twin")
        train, val, test = make_synthetic_splits(
            "food101", int(args.num_classes), int(getattr(args, "seed", 0)),
            n_train=128, n_val=32, n_test=32)
        synthetic = True
    return DataBundle(train, val, test, train_sampler="sequential",
                      synthetic=synthetic)


def _get_legacy_data(args, data_dir: str) -> DataBundle:
    """The legacy feed (food101/get_data_old.py): ``texts_train.csv`` for
    train, ``texts_test.csv`` for val and test, read in order (the legacy
    types run through the same sampler-less, shuffle-less runner,
    food101/run_training.py:39-45); without ``texts_train.csv``, the
    synthetic twin ``food101_legacy``."""
    if os.path.exists(os.path.join(data_dir, "texts_train.csv")):
        from ..data.food101_legacy import Food101LegacyDiskDataset

        train = Food101LegacyDiskDataset(data_dir, "train", args)
        val = Food101LegacyDiskDataset(data_dir, "test", args)
        return DataBundle(train, val, val, train_sampler="sequential",
                          synthetic=False)
    print(f"[food101] legacy texts_train.csv not found under {data_dir!r}; "
          "using synthetic twin")
    train, val, test = make_synthetic_splits(
        "food101_legacy", int(args.num_classes),
        int(getattr(args, "seed", 0)), n_train=128, n_val=32, n_test=32)
    return DataBundle(train, val, test, train_sampler="sequential",
                      synthetic=True)


def load_pretrained(args, state):
    """Tower weights from local checkpoints, in place; a no-op when unset.

      * ``siglip_weights``: an HF SigLIP snapshot directory
        (``model.safetensors`` or ``pytorch_model.bin``) for the SigLIP
        family;
      * ``resnet50_weights``: a torchvision resnet50 state_dict into the
        legacy image tower's ``features`` by name (its ``fc`` and
        ``num_batches_tracked`` dropped: the head is fresh);
      * ``bert_weights``: an HF bert-base checkpoint (a file or snapshot
        directory; keys under ``bert.`` for a ``BertFor...`` one) into the
        legacy text tower's encoder (food101/joint_model_proba_logits.py:
        52-66 loads IMAGENET1K_V2 and bert-base-uncased).
    """
    ckpt = getattr(args, "siglip_weights", None)
    if ckpt:
        load_hf_siglip_params(ckpt, state.model.model)
        print(f"[food101] loaded SigLIP weights from {ckpt}")
    r50 = getattr(args, "resnet50_weights", None)
    bert = getattr(args, "bert_weights", None)
    if not (r50 or bert):
        return state
    if not isinstance(state.model, Food101LegacyFusionNet):
        raise ValueError(
            "resnet50_weights/bert_weights apply to the legacy "
            "jprobas/jprobas_jlogits variants only (current model_type="
            f"{getattr(args, 'model_type', '?')!r})")
    if r50:
        copy_by_name(torch_state_dict(r50), state.model.x1_model.features,
                     what="torchvision resnet50")
        print(f"[food101] loaded resnet50 tower from {r50}")
    if bert:
        load_hf_bert_params(bert, state.model.x2_model.model)
        print(f"[food101] loaded BERT tower from {bert}")
    return state


def get_model_spec(args, n_train: int, mesh=None) -> Tuple[ModelSpec, Dict]:
    """``mesh``: the run's (``parallel/mesh.py``), which the SigLIP towers
    take where ``pipeline_stages`` > 1 (GPipe over its stage axis) or
    ``sequence_sharding`` is set (the tokens over its model axis)."""
    model_type = getattr(args, "model_type", "qmf")
    if model_type not in MODEL_TYPES:
        raise NotImplementedError(f"food101 model_type {model_type!r}")
    if model_type in LEGACY_TYPES:
        legacy = Food101LegacyFusionNet(
            int(args.num_classes),
            stage_sizes=tuple(getattr(args, "legacy_stages", (3, 4, 6, 3))),
            bert_layers=int(getattr(args, "legacy_bert_layers", 12)),
            bert_width=int(getattr(args, "legacy_bert_width", 768)),
            bert_heads=int(getattr(args, "legacy_bert_heads", 12)),
            bert_vocab=int(getattr(args, "legacy_bert_vocab", 30522)),
            dtype=resolve_dtype(args))
        # StepLR(500, 0.75): food101/joint_model_proba_logits.py:282
        spec = ModelSpec(
            module=legacy, contract="jprobas",
            frozen_prefixes=("x1_model.features", "x2_model.model"),
            eval_fusion=("logits" if model_type == "jprobas_jlogits"
                         else None),
            sched_step_size=500, sched_gamma=0.75)
        return spec, {}
    pp_stages = int(getattr(args, "pipeline_stages", 0) or 0)
    seq_sharding = bool(getattr(args, "sequence_sharding", False))
    module = Food101FusionNet(
        int(args.num_classes), resolve_dtype(args),
        pipeline_stages=pp_stages,
        pipeline_microbatches=int(getattr(args, "pipeline_microbatches", 4)),
        sequence_sharding=seq_sharding,
        mesh=mesh if (pp_stages > 1 or seq_sharding) else None)
    common = dict(module=module, sched_step_size=50, sched_gamma=0.5)
    if model_type == "ogm_ge":
        spec = ModelSpec(contract="ogm_ge",
                         grad_mod_type=getattr(args, "grad_mod_type",
                                               "OGM_GE"),
                         ogm_alpha=float(getattr(args, "alpha", 0.1)),
                         **common)
    elif model_type == "qmf":
        spec = ModelSpec(contract="qmf", n_train_samples=n_train, **common)
    else:
        spec = ModelSpec(contract=model_type, **common)
    return spec, {}
