"""Config resolution and seeding for the
``python -m multimodal_clinical_tpu_torch --dir <dataset>`` CLI (port of
``multimodal_clinical_tpu/config/setup.py``).

Mirrors the reference flow (utils/setup_configs.py:7-35): parse ``--dir``,
deep-merge ``configs/base_cfg.yaml`` with ``configs/<dataset>.yaml`` of
this repository (or the reference's ``utils/base_cfg.yaml`` +
``<dir>/<dir>.yaml`` layout when those exist), flatten the keys onto a
namespace, and seed Python's, numpy's and torch's global generators.
``--set key=value`` values are read by the port's YAML-subset reader
(``merge.safe_load``); a value it cannot read raises.
"""

from __future__ import annotations

import argparse
import os
import random
from types import SimpleNamespace
from typing import Any, Dict, Optional

import numpy as np
import torch

from .merge import load_and_merge_yaml, load_yaml, safe_load

# Repo root = two levels above this file's package.
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

KNOWN_DATASETS = (
    "avmnist",
    "mimic",
    "enrico",
    "cremad",
    "food101",
    "ave",
    "vggsound",
    "mustard",
    "fakenews",
)


def _config_paths(dataset_dir: str, root: Optional[str] = None):
    """Resolve (base, override) YAML paths for a dataset name."""
    root = root or _REPO_ROOT
    new_base = os.path.join(root, "configs", "base_cfg.yaml")
    new_override = os.path.join(root, "configs", dataset_dir + ".yaml")
    if os.path.exists(new_base) and os.path.exists(new_override):
        return new_base, new_override
    ref_base = os.path.join(root, "utils", "base_cfg.yaml")
    ref_override = os.path.join(root, dataset_dir, dataset_dir + ".yaml")
    if os.path.exists(ref_base) and os.path.exists(ref_override):
        return ref_base, ref_override
    raise FileNotFoundError(
        f"No config found for dataset '{dataset_dir}' (looked for "
        f"{new_override} and {ref_override})"
    )


def seed_everything(seed: int) -> int:
    """Seed the host's global generators: Python's, numpy's and torch's.
    The port's own draws (weights, per-step masks, samplers) take explicit
    generators from the seed and do not read these."""
    seed = int(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


def config_to_args(cfg: Dict[str, Any]) -> SimpleNamespace:
    args = SimpleNamespace()
    for key, val in cfg.items():
        setattr(args, key, val)
    return args


def load_config(dataset_dir: str, root: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> SimpleNamespace:
    """Load merged config for a dataset and return a flat namespace."""
    base_file, override_file = _config_paths(dataset_dir, root)
    cfg = load_and_merge_yaml(base_file, override_file)
    if overrides:
        cfg.update(overrides)
    args = config_to_args(cfg)
    args.dir = dataset_dir
    seed_everything(getattr(args, "seed", 0))
    return args


def setup_configs(argv=None) -> SimpleNamespace:
    """Parse ``--dir`` (plus optional ``--seed``/``--set k=v``) and load config."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--dir", type=str, default=None)
    parser.add_argument("--config", type=str, default=None,
                        help="single YAML merged over base_cfg (the legacy "
                             "runners' flag, e.g. ave/run_training.py:28-37); "
                             "the dataset is inferred from the file stem")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--resume", action="store_true",
                        help="resume from the run's rolling 'last' checkpoint")
    parser.add_argument(
        "--set",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="override any config key, e.g. --set num_epochs=2",
    )
    args_cli = parser.parse_args(argv)
    if not args_cli.dir and not args_cli.config:
        raise NotImplementedError("No directory provided, please specify flag --dir")

    overrides: Dict[str, Any] = {}
    if args_cli.config:
        # legacy single-yaml mode: the file's contents become overrides on
        # top of the normal base+dataset merge; without --dir the dataset
        # name is the file stem
        if not args_cli.dir:
            args_cli.dir = os.path.splitext(
                os.path.basename(args_cli.config))[0]
        overrides.update(load_yaml(args_cli.config))
    for item in args_cli.set:
        key, sep, raw = item.partition("=")
        if not sep or not key:
            raise ValueError(f"--set takes KEY=VALUE, got {item!r}")
        try:
            overrides[key] = safe_load(raw)
        except ValueError as exc:
            raise ValueError(f"--set {key}: {exc}") from exc
    if args_cli.seed is not None:
        overrides["seed"] = args_cli.seed
    overrides["resume"] = bool(args_cli.resume)

    return load_config(args_cli.dir, overrides=overrides)
