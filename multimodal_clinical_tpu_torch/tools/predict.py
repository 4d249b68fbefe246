"""Batch inference from a checkpoint (port of the JAX package's
``tools/predict.py``): load a trained checkpoint, run the eval step over a
split, and write one CSV row per sample.

    python -m multimodal_clinical_tpu_torch.tools.predict --dir cremad \\
        --ckpt data/cremad_ckpts/<group>/ckpt [--split test|val|train] \\
        [--which best|last] [--out preds.csv] [--device cuda|cpu] \\
        [--set key=value ...]

Each row of a valid sample: its idx, label, the fused argmax prediction,
the per-modality argmax predictions and the fused max log-probability.
The rows come from the same eval step as validation (``make_eval_step``),
so serving numerics are eval numerics.  Runs on the CUDA device unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import copy
import csv
import os
from dataclasses import replace

import numpy as np

from ..engine.checkpoint import BestCheckpointer
from ..engine.run import build_loaders
from ..engine.state import create_train_state
from ..engine.steps import make_eval_step
from ..utils.device import resolve_device


def restore_state(args, benchmark, ckpt_dir: str, which: str, device):
    """(data, spec, state) with ``state`` restored from the ``best`` or the
    newest ``last`` checkpoint under ``ckpt_dir``; raises when that
    checkpoint is not there, so a mistyped path never serves fresh
    weights."""
    data = benchmark.get_data(args)
    spec, opt_kwargs = benchmark.get_model_spec(args, n_train=len(data.train))
    steps_per_epoch = max(1, -(-len(data.train) // int(args.batch_size)))
    state = create_train_state(spec, args, int(getattr(args, "seed", 0)),
                               steps_per_epoch, device=device,
                               **(opt_kwargs or {}))
    ck = BestCheckpointer(ckpt_dir)
    if which == "last":
        restored = ck.restore_last(state)
        if restored is None:
            raise FileNotFoundError(f"no rolling checkpoint under {ckpt_dir}")
        return data, spec, restored
    state = ck.restore_best(state)
    if ck.best_path is None:
        raise FileNotFoundError(f"no best checkpoint under {ckpt_dir}")
    return data, spec, state


def prob_fusion(spec) -> bool:
    """jprobas reports log-probabilities and fuses the mean probability;
    every other contract (ensemble included) fuses the plain logits mean:
    MIMIC's w1/w2 weighting is train-only, its test step fuses (x1+x2)/2
    (mimic/ensemble_model.py:234-239)."""
    return (spec.contract == "jprobas"
            and (spec.eval_fusion or "probas") == "probas")


def predict(args, benchmark, split: str, ckpt_dir: str, which: str,
            device="cuda"):
    """Returns (rows, summary): per-sample prediction rows and accuracy."""
    device = resolve_device(device)
    data, spec, state = restore_state(args, benchmark, ckpt_dir, which,
                                      device)
    if split == "train":
        # one deterministic row per sample: bypass the training sampler
        # (Crema-D, AVE, Enrico and VGGSound sample with replacement) and
        # gather in eval mode (no random augmentation)
        eval_train = copy.copy(data.train)
        if hasattr(eval_train, "train"):
            eval_train.train = False
        data = replace(data, train=eval_train, train_sampler="sequential")
    loaders = dict(zip(("train", "val", "test"),
                       build_loaders(args, data, device)))
    eval_step = make_eval_step(spec)
    fuse_probas = prob_fusion(spec)

    rows = []
    n_correct = 0
    for batch in loaders[split]:
        out = eval_step(state, batch)
        stack = out["logits_stack"].float().cpu().numpy()     # (B, M, C)
        label = out["label"].cpu().numpy()
        valid = out["valid"].cpu().numpy() > 0
        idx = batch["idx"].cpu().numpy()
        if fuse_probas:
            fused = np.exp(stack).mean(axis=1)               # mean probability
            logp = np.log(np.maximum(fused, 1e-30))
        else:
            fused = stack.mean(axis=1)
            shifted = fused - fused.max(-1, keepdims=True)
            logp = shifted - np.log(np.exp(shifted).sum(-1, keepdims=True))
        pred = fused.argmax(-1)
        uni_preds = stack.argmax(-1)                         # (B, M)
        for b in range(len(label)):
            if not valid[b]:
                continue
            n_correct += int(pred[b] == label[b])
            rows.append([int(idx[b]), int(label[b]), int(pred[b]),
                         *[int(p) for p in uni_preds[b]],
                         float(logp[b, pred[b]])])
    acc = n_correct / max(len(rows), 1)
    return rows, {"n": len(rows), "acc": acc}


def write_rows(path: str, rows) -> None:
    num_mod = len(rows[0]) - 4 if rows else 2
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["idx", "label", "pred",
                    *[f"pred_x{m + 1}" for m in range(num_mod)],
                    "fused_logprob"])
        w.writerows(rows)


def config_from(a) -> "argparse.Namespace":
    """The run's config from a tool's ``--dir``, ``--seed`` and ``--set``."""
    from ..config import setup_configs

    cfg_argv = ["--dir", a.dir]
    if a.seed is not None:
        cfg_argv += ["--seed", str(a.seed)]
    for kv in a.set:
        cfg_argv += ["--set", kv]
    return setup_configs(cfg_argv)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint dir (the trainer's <run_dir>/ckpt)")
    ap.add_argument("--split", choices=("train", "val", "test"),
                    default="test")
    ap.add_argument("--which", choices=("best", "last"), default="best")
    ap.add_argument("--out", default=None,
                    help="CSV path (default <ckpt>/predictions_<split>.csv)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--set", action="append", default=[],
                    metavar="key=value")
    a = ap.parse_args(argv)

    from ..benchmarks import get_benchmark

    args = config_from(a)
    rows, summary = predict(args, get_benchmark(args.dir), a.split, a.ckpt,
                            a.which, device=a.device)
    out_path = a.out or os.path.join(a.ckpt, f"predictions_{a.split}.csv")
    write_rows(out_path, rows)
    print(f"[predict] {summary['n']} samples, {a.split} acc "
          f"{summary['acc']:.4f} -> {out_path}")
    return summary


if __name__ == "__main__":
    main()
