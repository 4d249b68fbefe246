"""End-to-end run wiring: data -> state -> Trainer -> fit -> test (port of
``multimodal_clinical_tpu/engine/run.py``).

Resolve the device, construct loaders with the dataset's sampler policy,
initialise the TrainState on the device, fit with best-checkpointing, and
test (utils/run_trainer.py:6-70).  One seed on one device; S seeds train
together in one process through ``engine/multiseed.py``.  The JAX
package's mesh, FSDP, pipeline and multi-host settings come with the
port's ``parallel/`` (ROADMAP.md queue A, item 18) and raise until then.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..data.loader import Loader
from ..data.sampler import RandomSampler, SequentialSampler, WeightedSampler
from ..utils.device import resolve_device
from .checkpoint import BestCheckpointer
from .state import create_train_state
from .trainer import Trainer


@dataclass
class DataBundle:
    train: Any
    val: Any
    test: Any
    # sampler policy per split: 'weighted' | 'random' | 'sequential'
    train_sampler: str = "random"
    val_sampler: str = "sequential"
    test_sampler: str = "sequential"
    synthetic: bool = False


def _make_sampler(kind: str, dataset, seed: int):
    if kind == "weighted":
        return WeightedSampler(dataset.labels, seed=seed)
    if kind == "random":
        return RandomSampler(len(dataset), seed=seed)
    return SequentialSampler(len(dataset))


def resolve_loader_workers(args) -> int:
    """Loader gather-thread count.  Default: the config's ``num_cpus`` (the
    reference maps it to 12 DataLoader workers, cremad/run_trainer.py:41-49)
    capped at host cores; ``loader_workers`` overrides explicitly."""
    workers = getattr(args, "loader_workers", None)
    if workers is None:
        host_cores = os.cpu_count() or 1
        workers = min(int(getattr(args, "num_cpus", 1) or 1), host_cores)
    return max(1, int(workers))


def transfer_dtype(args) -> Optional[torch.dtype]:
    """bf16 feature transfer (half the bytes to copy) when the model
    computes in bf16 anyway; ``transfer_dtype: float32`` opts out."""
    if (getattr(args, "compute_dtype", None) == "bfloat16"
            and getattr(args, "transfer_dtype", "auto") != "float32"):
        return torch.bfloat16
    return None


def build_loaders(args, data: DataBundle, device="cuda"
                  ) -> Tuple[Loader, Loader, Loader]:
    """Per-split loaders; the splits' sampler seeds are offset 0/1/2."""
    seed = int(getattr(args, "seed", 0))
    workers = resolve_loader_workers(args)

    def loader(split, kind, seed_offset):
        return Loader(split, int(args.batch_size),
                      _make_sampler(kind, split, seed + seed_offset),
                      workers=workers, transfer_dtype=transfer_dtype(args),
                      device=device)

    return (
        loader(data.train, data.train_sampler, 0),
        loader(data.val, data.val_sampler, 1),
        loader(data.test, data.test_sampler, 2),
    )


def _refuse_parallel_settings(args) -> None:
    """The settings the JAX package spreads over a mesh or hosts."""
    set_ = [key for key in ("mesh_shape", "fsdp", "pipeline_stages",
                            "sequence_sharding", "dist_init",
                            "dist_coordinator")
            if getattr(args, key, None) not in (None, False, 0)]
    if set_:
        raise NotImplementedError(
            f"{set_} set: the port runs on one device until its parallel/ "
            "package lands (ROADMAP.md queue A, item 18)")


def run_benchmark(args, benchmark_module, profile_dir: Optional[str] = None,
                  device="cuda") -> Dict[str, float]:
    """Full fit+test for one benchmark; returns the test-epoch summary."""
    device = resolve_device(device)
    _refuse_parallel_settings(args)
    data: DataBundle = benchmark_module.get_data(args)
    spec, opt_kwargs = benchmark_module.get_model_spec(
        args, n_train=len(data.train))
    train_loader, val_loader, test_loader = build_loaders(args, data, device)
    steps_per_epoch = max(1, -(-len(data.train) // int(args.batch_size)))
    state = create_train_state(spec, args, int(getattr(args, "seed", 0)),
                               steps_per_epoch, device=device,
                               **(opt_kwargs or {}))
    # optional pretrained weights from local files (the reference downloads
    # them at construction, enrico/joint_model.py:28)
    load_pretrained = getattr(benchmark_module, "load_pretrained", None)
    if load_pretrained is not None:
        state = load_pretrained(args, state)
    # optional warm start from a saved checkpoint's weights (the
    # reference's analysis variants load a fixed ckpt by path,
    # enrico/joint_model_counts.py:100-107)
    init_ckpt = getattr(args, "init_ckpt", None)
    if init_ckpt:
        loader_ckpt = BestCheckpointer(init_ckpt)
        if not loader_ckpt.has_checkpoint():
            raise FileNotFoundError(f"init_ckpt {init_ckpt!r} holds no "
                                    "checkpoint")
        if loader_ckpt.restore_last(state, weights_only=True) is None:
            loader_ckpt.restore_best(state, weights_only=True)
        print(f"[run] warm-started weights from {init_ckpt}")
    trainer = Trainer(args, spec, state, train_loader, val_loader, test_loader,
                      profile_dir=profile_dir)
    if getattr(args, "resume", False):
        trainer.resume()
    trainer.fit()
    # legacy standalone runners test the final-epoch weights; new-style
    # dirs reload the best-val checkpoint first (utils/run_trainer.py:65)
    return trainer.test(restore_best=spec.test_restore_best)
