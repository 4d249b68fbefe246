"""End-to-end run wiring: data -> state -> Trainer -> fit -> test (port of
``multimodal_clinical_tpu/engine/run.py``).

Resolve the device and the mesh over the ranks, construct loaders with
the dataset's sampler policy (each rank its shard of the global stream),
initialise the TrainState on the device and place it on the mesh (tensor
parallelism on the model axis, GPipe stages on the stage axis, FSDP with
``fsdp: true``), fit with best-checkpointing, and test
(utils/run_trainer.py:6-70).  S seeds train together in one process
through ``engine/multiseed.py``.  The JAX package's parallel settings:
``dist_*``, ``mesh_shape: {data: D, model: M, stage: S}``, ``fsdp``, and
for the benchmarks whose ``get_model_spec`` takes a mesh (Food101)
``pipeline_stages``, ``pipeline_microbatches`` and ``sequence_sharding``.
"""

from __future__ import annotations

import inspect
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..data.loader import Loader
from ..data.sampler import RandomSampler, SequentialSampler, WeightedSampler
from ..parallel.distributed import rank, world_size
from ..parallel.mesh import DATA_AXIS, Mesh, make_mesh
from ..parallel.sharding import place_state
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


def _make_sampler(kind: str, dataset, seed: int, process_index: int = 0,
                  process_count: int = 1):
    proc = dict(process_index=process_index, process_count=process_count)
    if kind == "weighted":
        return WeightedSampler(dataset.labels, seed=seed, **proc)
    if kind == "random":
        return RandomSampler(len(dataset), seed=seed, **proc)
    return SequentialSampler(len(dataset), **proc)


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


def build_loaders(args, data: DataBundle, device="cuda",
                  mesh: Optional[Mesh] = None
                  ) -> Tuple[Loader, Loader, Loader]:
    """Per-split loaders; the splits' sampler seeds are offset 0/1/2.
    Under data parallelism every rank derives the same global per-epoch
    index stream and loads its data coordinate's strided shard of it
    (``stream[d::D]``, ``data/sampler.py``), ``batch_size / D`` rows a
    step, onto its own device: the ranks of one data coordinate (its
    model and stage ranks) take the same rows, as JAX's ``P("data")``
    gives them."""
    bs = int(args.batch_size)
    dp = 1 if mesh is None else mesh.shape[DATA_AXIS]
    if bs % dp != 0:
        raise ValueError(
            f"batch_size {bs} not divisible by data-axis size {dp}")
    pc = world_size()
    if bs % pc != 0:
        raise ValueError(f"batch_size {bs} not divisible by process count {pc}")
    pi, pc = ((rank(), pc) if mesh is None
              else (mesh.coordinate(DATA_AXIS), dp))
    seed = int(getattr(args, "seed", 0))
    workers = resolve_loader_workers(args)

    def loader(split, kind, seed_offset):
        return Loader(split, bs // pc,
                      _make_sampler(kind, split, seed + seed_offset, pi, pc),
                      workers=workers, transfer_dtype=transfer_dtype(args),
                      device=device)

    return (
        loader(data.train, data.train_sampler, 0),
        loader(data.val, data.val_sampler, 1),
        loader(data.test, data.test_sampler, 2),
    )


def _accepts_mesh(benchmark_module) -> bool:
    """Whether the benchmark's ``get_model_spec`` takes a ``mesh`` (or
    ``**kwargs``): the benchmarks with a mesh-aware model opt in."""
    params = inspect.signature(benchmark_module.get_model_spec).parameters
    return "mesh" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def run_benchmark(args, benchmark_module, profile_dir: Optional[str] = None,
                  device="cuda") -> Dict[str, float]:
    """Full fit+test for one benchmark; returns the test-epoch summary.
    ``device`` is this rank's (``parallel/distributed.py``)."""
    device = resolve_device(device)
    mesh = make_mesh(getattr(args, "mesh_shape", None) or None,
                     device.type)
    data: DataBundle = benchmark_module.get_data(args)
    # a pipeline_stages config on a benchmark whose model takes no mesh is
    # a loud error, in the JAX package's words (engine/run.py:147-155)
    accepts_mesh = _accepts_mesh(benchmark_module)
    if int(getattr(args, "pipeline_stages", 0) or 0) > 1 and not accepts_mesh:
        raise NotImplementedError(
            f"pipeline_stages is set but the {args.dir!r} benchmark's "
            "get_model_spec does not accept a mesh — pipeline parallelism "
            "is wired for benchmarks that opt in (food101)")
    spec, opt_kwargs = benchmark_module.get_model_spec(
        args, n_train=len(data.train),
        **({"mesh": mesh} if accepts_mesh else {}))
    train_loader, val_loader, test_loader = build_loaders(args, data, device,
                                                          mesh)
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
    # the TP and stage rules where the mesh has those axes, FSDP over the
    # data axis with ``fsdp: true``, every other leaf replicated (every
    # rank draws and loads the same weights)
    state = place_state(state, mesh, fsdp=bool(getattr(args, "fsdp", False)))
    trainer = Trainer(args, spec, state, train_loader, val_loader, test_loader,
                      profile_dir=profile_dir)
    if getattr(args, "resume", False):
        trainer.resume()
    trainer.fit()
    # legacy standalone runners test the final-epoch weights; new-style
    # dirs reload the best-val checkpoint first (utils/run_trainer.py:65)
    return trainer.test(restore_best=spec.test_restore_best)
