"""Multi-seed sweep: S seeds trained as one program a step (port of
``multimodal_clinical_tpu/engine/multiseed.py``).

The reference runs seed sweeps as parallel OS processes
(enrico/run_parallel.sh:1-12, mimic/run_parallel.sh: 20 background python
jobs) and aggregates exported CSVs offline (mimic/analyze_data.py:4-23).
Here, as in the JAX package, S model replicas train together: their
parameters and buffers are stacked on a leading seed axis, and each step
runs the forward and the loss once for all S seeds (``torch.func.vmap``
over ``torch.func.functional_call``), one backward and one optimizer step
over the stacked leaves.  Every kernel launch on the towers then serves S
seeds: the seed-grouped convolutions and matmuls of vmap's batching
rules, and the ``vmap`` rules of ``ops/maxpool.py`` and ``ops/fused_bn.py``
for the hand-written kernels.  Each seed keeps its own init, data order,
dropout masks, OGM-GE noise and SpecAugment draws: seed s of the sweep
computes what ``engine/run.py::run_benchmark`` with ``seed = s`` computes,
to rounding.

SGD's momentum and weight decay and Adam's moments are elementwise and the
LR schedule is shared, so one torch optimizer over the stacked leaves is
exactly S per-seed optimizers.

Eval reports per-seed metrics plus mean and std (the analyze_data.py
aggregation, live instead of offline) and ``seeds.csv``.  As the JAX
sweep, this one calls neither the benchmark's ``load_pretrained`` nor
``init_ckpt``, writes no checkpoint, and ignores ``--resume``, the mesh
settings and ``profile_dir``.
"""

from __future__ import annotations

import copy
import csv
import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, vmap

from ..algos.ogm_ge import (
    NoiseSource, device_noise, modulate_stacked_gradients, ogm_coefficients,
)
from ..algos.qmf import init_history
from ..data.loader import DeviceCopy, Loader, prefetched_iter
from ..models.common import MaskSource, dropout_source, init_weights
from ..parallel.distributed import world_size
from ..utils.device import resolve_device
from .metrics import (
    EpochAccumulator, eval_epoch_summary, to_host, train_epoch_summary,
)
from .spec import ModelSpec
from .state import (
    decay_groups, make_optimizer, spec_lr_schedule, step_generator,
)
from .steps import (
    _model_inputs, _train_loss, _train_metrics, device_dropout, eval_outputs,
    history_of,
)

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class MultiSeedState:
    """The sweep's state: ``model`` is the structure that
    ``functional_call`` runs (its own tensors live on the meta device);
    ``params`` and ``buffers`` are the S seeds' tensors by name, stacked
    on a leading seed axis, the params leaf tensors that ``optimizer``
    updates; ``ema`` (S, M, C); the QMF History (S, M, n_train) or None;
    one ``step`` for all seeds."""
    step: int
    model: nn.Module
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    ema: torch.Tensor
    seeds: List[int]
    lr_schedule: Callable[[int], float]
    qmf_correctness: Optional[torch.Tensor] = None
    qmf_confidence: Optional[torch.Tensor] = None


def _stack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The seeds' tensors on a leading axis; 4-D conv weights stacked so
    that the (S * Cout, Cin, kh, kw) view that the seed-grouped
    convolution takes is channels_last, as each seed's weight is."""
    if tensors[0].dim() == 4:
        return torch.stack([t.permute(0, 2, 3, 1) for t in tensors]
                           ).permute(0, 1, 4, 2, 3)
    return torch.stack(list(tensors))


def create_multiseed_state(spec: ModelSpec, args, seeds: Sequence[int],
                           steps_per_epoch: int, device="cuda",
                           opt_kwargs: Optional[Dict] = None
                           ) -> MultiSeedState:
    """S models drawn as ``create_train_state`` draws each (the weights of
    ``spec.module`` from ``torch.Generator().manual_seed(s)``), stacked on
    a leading seed axis on ``device``, with one optimizer over the stacked
    leaves, the EMA and (under the qmf contract) the History tables."""
    device = resolve_device(device)
    opt = dict(opt_kwargs or {})
    lr_override = opt.pop("lr_override", None)
    per_seed: Dict[str, List[torch.Tensor]] = {}
    # the draws fill each tensor in memory order: draw into the layout
    # of a module as its constructor leaves it, as a single run does
    spec.module.to(memory_format=torch.contiguous_format)
    for s in seeds:
        model = init_weights(spec.module,
                             torch.Generator().manual_seed(int(s)))
        for name, t in (*model.named_parameters(), *model.named_buffers()):
            per_seed.setdefault(name, []).append(
                t.detach().to(device, copy=True))
    param_names = {name for name, _ in spec.module.named_parameters()}
    stacked = {name: _stack(ts) for name, ts in per_seed.items()}
    del per_seed
    params = {name: t.requires_grad_() for name, t in stacked.items()
              if name in param_names}
    buffers = {name: t for name, t in stacked.items()
               if name not in param_names}
    schedule = spec_lr_schedule(spec, args, steps_per_epoch, lr_override)
    optimizer = make_optimizer(decay_groups(params, spec.frozen_prefixes),
                               schedule(0), **opt)
    num_seeds = len(seeds)
    ema = torch.zeros(num_seeds, spec.num_modality, int(args.num_classes),
                      dtype=torch.float32, device=device)
    qmf_corr = qmf_conf = None
    if spec.contract == "qmf":
        qmf_corr, qmf_conf = (
            t.expand(num_seeds, *t.shape).clone()
            for t in init_history(spec.num_modality, spec.n_train_samples,
                                  device))
    return MultiSeedState(
        step=0, model=copy.deepcopy(spec.module).to("meta"), params=params,
        buffers=buffers, optimizer=optimizer, ema=ema,
        seeds=[int(s) for s in seeds], lr_schedule=schedule,
        qmf_correctness=qmf_corr, qmf_confidence=qmf_conf)


class MultiSeedLoader:
    """Stacks S per-seed index streams into (S, B, ...) superbatches.

    ``datasets`` is either ONE dataset shared by every seed or a list of S
    per-seed datasets (the reference's 50-seed protocol re-seeds the global
    RNG per run, so each run's get_data() draws a DIFFERENT construction
    shuffle and split, mimic/get_data.py:86; run_multiseed builds per-seed
    bundles to match).  Each seed's host batches are ``Loader``'s, in fp32
    (no transfer cast, as the JAX sweep's); a producer thread stacks the
    next superbatch and copies it to ``device`` while the current step
    runs."""

    def __init__(self, datasets, batch_size: int, samplers,
                 prefetch: int = 2, workers: int = 1, device="cuda"):
        if not isinstance(datasets, (list, tuple)):
            datasets = [datasets] * len(samplers)
        if len(datasets) != len(samplers):
            raise ValueError(f"{len(datasets)} datasets vs "
                             f"{len(samplers)} samplers")
        self.loaders = [
            Loader(dataset, batch_size, sampler, prefetch=1, workers=workers,
                   device="cpu")
            for dataset, sampler in zip(datasets, samplers)
        ]
        self.prefetch = max(1, int(prefetch))
        self._copy = DeviceCopy(device)

    def set_epoch(self, epoch: int) -> None:
        for loader in self.loaders:
            loader.set_epoch(epoch)

    def __len__(self) -> int:
        return min(len(l) for l in self.loaders)

    def _host_superbatches(self):
        iters = [iter(l._host_batches()) for l in self.loaders]
        while True:
            try:
                batches = [next(it) for it in iters]
            except StopIteration:
                return
            yield {k: torch.stack([b[k] for b in batches])
                   for k in batches[0]}

    def __iter__(self):
        return prefetched_iter(self._host_superbatches(), self._copy.put,
                               self.prefetch, take=self._copy.take)


def seed_masks(sources: Sequence[MaskSource],
               position: torch.Tensor) -> MaskSource:
    """Inside the sweep's vmap: every dropout draws seed s's mask from seed
    s's source, in the order its run draws them.  Each source draws the
    per-seed shape; the (S, *shape) stack is indexed by the batched seed
    ``position``, so each seed's slice of the batch gets its own."""
    def source(shape, keep_prob, device):
        masks = torch.stack([src(shape, keep_prob, device)
                             for src in sources])
        return masks[position]

    return source


def _fold(batch: Batch) -> Tuple[Batch, int]:
    seeds = next(iter(batch.values())).shape[0]
    return {k: v.flatten(0, 1) for k, v in batch.items()}, seeds


def _unfold(batch: Batch, seeds: int) -> Batch:
    return {k: v.unflatten(0, (seeds, -1)) for k, v in batch.items()}


def make_multiseed_steps(
    spec: ModelSpec, per_seed_eval_data: bool = False,
    ogm_noise: Optional[Callable[[int, int], NoiseSource]] = None,
    dropout: Optional[Callable[[int, int], MaskSource]] = None,
):
    """(train_step, eval_step) of the sweep.

    ``train_step(state, batch) -> (state, metrics)``: ``batch`` holds
    (S, B, ...) superbatches.  The device preprocess runs once on the
    folded (S * B, ...) rows, SpecAugment drawing seed s's rows from
    ``step_generator(seed_s, step)``; then one vmap over the seeds runs the
    forward, the contract's loss, the EMA, the metrics, the QMF History
    scatter and the OGM-GE coefficients; one backward; the OGM-GE
    modulation per seed slice; one optimizer step.  Metrics come back
    (S,)-shaped.  ``ogm_noise(seed, step)`` and ``dropout(seed, step)``
    give a seed's noise and dropout sources, by default
    ``device_noise`` and ``device_dropout``, those of ``make_train_step``.

    ``eval_step(state, batch) -> outputs`` with (S, ...) entries: the
    batch is (S, B, ...) when ``per_seed_eval_data`` (per-seed val and test
    splits), else one (B, ...) batch shared by every seed."""
    if ogm_noise is None:
        ogm_noise = device_noise
    if dropout is None:
        dropout = device_dropout
    modulate = bool(spec.apply_grad_mod and spec.grad_mod_type)

    def train_step(state: MultiSeedState, batch: Batch):
        seeds, step = state.seeds, state.step
        if spec.device_preprocess is not None:
            folded, s = _fold(batch)
            batch = _unfold(spec.device_preprocess(
                folded, [step_generator(seed, step) for seed in seeds], True),
                s)
        sources = [dropout(seed, step) for seed in seeds]
        # () for no tables: vmap takes no None where it maps an argument
        history = history_of(state) or ()

        def one_seed(params, buffers, batch, ema, history, position):
            label, valid = batch["label"], batch["valid"]
            with dropout_source(seed_masks(sources, position)):
                out = functional_call(state.model, (params, buffers),
                                      tuple(_model_inputs(batch, spec)))
            aux: Dict = {}
            loss = _train_loss(spec, history or None, batch, out, aux)
            with torch.no_grad():
                new_ema, metrics = _train_metrics(spec, ema, aux,
                                                  loss.detach(), label, valid)
                extra = {}
                if "new_corr" in aux:
                    extra["history"] = (aux["new_corr"], aux["new_conf"])
                if modulate:
                    raw = out["logits"]
                    extra["coeffs"] = ogm_coefficients(
                        raw[0].detach(), raw[1].detach(), label,
                        spec.ogm_alpha, valid)
            return loss, new_ema, metrics, extra

        state.model.train()
        position = torch.arange(len(seeds), device=state.ema.device)
        # "same": a random op inside runs once for every seed; the only
        # ones here are the dropout sources' draws, from explicit per-seed
        # generators, each seed's picked by its position
        loss, new_ema, metrics, extra = vmap(one_seed, randomness="same")(
            state.params, state.buffers, batch, state.ema, history, position)
        state.optimizer.zero_grad(set_to_none=True)
        loss.sum().backward()
        if modulate:
            modulate_stacked_gradients(
                state.model, {name: p.grad for name, p in state.params.items()
                              if p.grad is not None}, extra["coeffs"],
                [ogm_noise(seed, step) for seed in seeds],
                modulation=spec.grad_mod_type)
        for group in state.optimizer.param_groups:
            group["lr"] = state.lr_schedule(step)
        state.optimizer.step()
        state.ema = new_ema
        if "history" in extra:
            state.qmf_correctness, state.qmf_confidence = extra["history"]
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def eval_step(state: MultiSeedState, batch: Batch):
        if spec.device_preprocess is not None:
            if per_seed_eval_data:
                folded, s = _fold(batch)
                batch = _unfold(spec.device_preprocess(folded, None, False), s)
            else:
                batch = spec.device_preprocess(batch, None, False)
        history = history_of(state) or ()

        def one_seed(params, buffers, batch, history):
            out = functional_call(state.model, (params, buffers),
                                  tuple(_model_inputs(batch, spec)))
            return eval_outputs(spec, batch, out, history or None)

        state.model.eval()
        return vmap(one_seed,
                    in_dims=(0, 0, 0 if per_seed_eval_data else None, 0))(
            state.params, state.buffers, batch, history)

    return train_step, eval_step


def multiseed_eval_summary(outputs: List[Dict], num_seeds: int, prefix: str
                           ) -> Dict[str, float]:
    """Per-seed epoch summaries + cross-seed mean/std (analyze_data.py)."""
    per_seed: List[Dict[str, float]] = []
    for s in range(num_seeds):
        seed_outputs = [
            {k: to_host(v)[s] for k, v in o.items()} for o in outputs
        ]
        per_seed.append(eval_epoch_summary(seed_outputs, prefix))
    summary: Dict[str, float] = {}
    for key in per_seed[0]:
        values = np.asarray([p[key] for p in per_seed])
        summary[key] = float(values.mean())
        summary[key + "_std"] = float(values.std())
        for s, v in enumerate(values):
            summary[f"{key}_seed{s}"] = float(v)
    return summary


class BestValTracker:
    """Per-seed best-val weight snapshots for the sweep.

    Mirrors the reference's per-run ModelCheckpoint(top-1 val_avg_acc,
    max) + reload-best-then-test flow (utils/run_trainer.py:27-33,65) on
    the stacked (S, ...) state: after each val epoch, seeds whose val
    accuracy strictly improved (ties keep the earlier epoch, like
    checkpoint.py's strictly-greater best) snapshot their param / buffer
    slices via a masked ``torch.where`` over the leading seed dim."""

    def __init__(self, n_seeds: int):
        self.n_seeds = n_seeds
        self.acc: Optional[np.ndarray] = None
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.stats: Optional[Dict[str, torch.Tensor]] = None

    def update(self, val_accs: np.ndarray, params: Dict[str, torch.Tensor],
               stats: Dict[str, torch.Tensor]) -> np.ndarray:
        if self.acc is None:
            improved = np.ones(self.n_seeds, bool)
            self.acc = np.asarray(val_accs, np.float32).copy()
        else:
            improved = np.asarray(val_accs) > self.acc
            self.acc = np.where(improved, val_accs, self.acc)
        if improved.any():
            if self.params is None:
                self.params = {k: v.detach().clone()
                               for k, v in params.items()}
                self.stats = {k: v.detach().clone() for k, v in stats.items()}
            else:
                def pick(new, old):
                    mask = torch.as_tensor(improved, device=new.device)
                    return torch.where(
                        mask.view((-1,) + (1,) * (new.dim() - 1)),
                        new.detach(), old)

                self.params = {k: pick(v, self.params[k])
                               for k, v in params.items()}
                self.stats = {k: pick(v, self.stats[k])
                              for k, v in stats.items()}
        return improved


def _refuse(args) -> None:
    """What the JAX sweep refuses, in its words, and the port's process
    settings that it cannot honour."""
    if world_size() > 1:
        # the vmapped sweep replicates each seed's full batch in the one
        # process; a rank's strided shard of the stream would feed each
        # process's copy of a seed other rows (JAX engine/multiseed.py:185)
        raise NotImplementedError(
            "num_seeds>1 is a single-process sweep (vmap over seeds); "
            "run one seed per process under torch.distributed")
    if getattr(args, "overfit_batches", 0):
        # the sweep trains per-seed data orders in one program; pinning
        # "the first k batches" is seed-ambiguous here
        raise NotImplementedError(
            "overfit_batches is a single-run sanity mode "
            "(utils/run_trainer.py:54); run it without num_seeds>1")
    if (int(getattr(args, "pipeline_stages", 0) or 0) > 1
            or getattr(args, "sequence_sharding", False)):
        raise NotImplementedError(
            "pipeline_stages / sequence_sharding need a device mesh; the "
            "vmapped multi-seed sweep runs mesh-less seed replicas — run "
            "one seed per job for pipelined/sequence-sharded models")


def run_multiseed(args, benchmark_module, seeds: List[int], device="cuda"
                  ) -> Dict[str, float]:
    """Train S seeds simultaneously; returns the cross-seed test summary."""
    from .run import _make_sampler, resolve_loader_workers

    device = resolve_device(device)
    _refuse(args)
    # Per-seed data: the reference's 50-seed protocol runs seed_everything
    # per process BEFORE get_data, so every run draws its own construction
    # shuffle AND split (mimic/get_data.py:86; run_parallel.sh): each seed
    # here gets its own bundle.  `multiseed_shared_data: true` opts out for
    # corpora too large to materialise S times.
    shared_data = bool(getattr(args, "multiseed_shared_data", False))
    if shared_data:
        bundles = [benchmark_module.get_data(args)] * len(seeds)
    else:
        bundles = []
        for s in seeds:
            a = copy.copy(args)
            a.seed = int(s)
            bundles.append(benchmark_module.get_data(a))
        lens = {(len(b.train), len(b.val), len(b.test)) for b in bundles}
        if len(lens) > 1:
            # unequal splits can't stack into (S, B, ...) superbatches
            raise NotImplementedError(
                f"per-seed get_data() produced unequal split sizes {lens}; "
                "run one seed per job, or set multiseed_shared_data: true")
    data = bundles[0]
    per_seed_eval = not shared_data
    spec, opt_kwargs = benchmark_module.get_model_spec(
        args, n_train=len(data.train))
    bs = int(args.batch_size)
    steps_per_epoch = max(1, -(-len(data.train) // bs))
    state = create_multiseed_state(spec, args, seeds, steps_per_epoch,
                                   device, opt_kwargs)

    workers = resolve_loader_workers(args)

    def sweep_loader(split: str, seed_offset: int):
        return MultiSeedLoader(
            [getattr(b, split) for b in bundles], bs,
            [_make_sampler(getattr(b, f"{split}_sampler"), getattr(b, split),
                           int(s) + seed_offset)
             for s, b in zip(seeds, bundles)],
            workers=workers, device=device)

    def shared_loader(split: str, seed_offset: int):
        return Loader(
            getattr(data, split), bs,
            _make_sampler(getattr(data, f"{split}_sampler"),
                          getattr(data, split),
                          int(getattr(args, "seed", 0)) + seed_offset),
            workers=workers, device=device)

    train_loader = sweep_loader("train", 0)
    # per-seed val/test sets stack like the train superbatches, with the
    # single run's +1/+2 sampler seed offsets and the bundle's policies
    eval_loader = sweep_loader if per_seed_eval else shared_loader
    val_loader, test_loader = eval_loader("val", 1), eval_loader("test", 2)

    train_step, eval_step = make_multiseed_steps(
        spec, per_seed_eval_data=per_seed_eval)

    def eval_epoch(loader, prefix):
        outputs = [{k: to_host(v) for k, v in eval_step(state, batch).items()}
                   for batch in loader]
        return multiseed_eval_summary(outputs, len(seeds), prefix)

    # per-seed best-val weight tracking: the reference's new-style sweep
    # reloads each run's top-1 val_avg_acc checkpoint before test
    # (utils/run_trainer.py:27-33,65); legacy dirs test final weights
    tracker = BestValTracker(len(seeds)) if spec.test_restore_best else None

    for epoch in range(int(args.num_epochs)):
        train_loader.set_epoch(epoch)
        acc = EpochAccumulator()
        for batch in train_loader:
            state, metrics = train_step(state, batch)
            # (S,) device vectors appended as-is; the one host fetch is in
            # the epoch summary, which flattens the S axis
            acc.append(metrics)
        train_summary = train_epoch_summary(acc)
        last_val = eval_epoch(val_loader, "val")
        if tracker is not None:
            tracker.update(
                np.array([last_val[f"val_epoch/val_avg_acc_seed{s}"]
                          for s in range(len(seeds))], np.float32),
                state.params, state.buffers)
        print(f"[multiseed epoch {epoch}] "
              f"train_avg_loss="
              f"{train_summary.get('train_epoch/train_avg_loss', 0):.4f}  "
              f"val_avg_acc={last_val.get('val_epoch/val_avg_acc', 0):.4f}"
              f" ± {last_val.get('val_epoch/val_avg_acc_std', 0):.4f}",
              flush=True)
    if tracker is not None and tracker.params is not None:
        # weights-only restore: QMF history tables keep their final-epoch
        # values, exactly like the reference's state_dict reload (History
        # lives outside the checkpoint, existing_algos/QMF.py:12-29)
        with torch.no_grad():
            for name, t in state.params.items():
                t.copy_(tracker.params[name])
            for name, t in state.buffers.items():
                t.copy_(tracker.stats[name])
    summary = eval_epoch(test_loader, "test")
    _write_seed_csv(args, seeds, summary)
    return summary


def _write_seed_csv(args, seeds, summary) -> None:
    """Persist per-seed test metrics as CSV: the artifact shape the
    reference exports from W&B for offline comparison
    (mimic/mimic_{ensemble,jlogits}.csv, mimic/analyze_data.py:4-23)."""
    data_path = str(getattr(args, "data_path", "runs")).rstrip("/")
    run_dir = (getattr(args, "ckpt_dir", None)
               or f"{data_path}_ckpts")
    run_dir = os.path.join(run_dir, str(getattr(args, "group_name", "run")))
    os.makedirs(run_dir, exist_ok=True)
    base_keys = sorted({k.rsplit("_seed", 1)[0] for k in summary
                        if "_seed" in k})
    path = os.path.join(run_dir, "seeds.csv")
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["seed"] + base_keys)
        for s_pos, seed in enumerate(seeds):
            writer.writerow(
                [seed] + [summary.get(f"{k}_seed{s_pos}", "")
                          for k in base_keys])
        writer.writerow(["mean"] + [summary.get(k, "") for k in base_keys])
        writer.writerow(["std"] + [summary.get(k + "_std", "")
                                   for k in base_keys])
    print(f"[multiseed] wrote per-seed metrics to {path}", flush=True)
