"""TrainState, LR schedule and optimizer (port of
``multimodal_clinical_tpu/engine/state.py``).

The JAX TrainState is an immutable pytree; here it is a small mutable
object that the train step updates in place: the model and the optimizer
own their tensors, ``ema`` and the QMF History tables are replaced each
step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import torch
from torch import nn

from ..algos.qmf import init_history
from ..models.common import init_weights
from ..utils.device import resolve_device
from .spec import ModelSpec


def make_lr_schedule(base_lr: float, use_scheduler: bool, steps_per_epoch: int,
                     step_size_epochs: int, gamma: float,
                     num_epochs: int) -> Callable[[int], float]:
    """StepLR-per-epoch as a per-step piecewise-constant schedule
    (utils/BaseModel.py:275-285): step -> learning rate."""
    if not use_scheduler or step_size_epochs <= 0:
        return lambda step: base_lr
    boundaries = []
    k = step_size_epochs
    while k <= max(num_epochs, step_size_epochs):
        boundaries.append(k * steps_per_epoch)
        k += step_size_epochs

    def schedule(step: int) -> float:
        return base_lr * gamma ** sum(step >= b for b in boundaries)

    return schedule


def decay_groups(model, frozen_prefixes: Sequence[str] = ()) -> List[Dict]:
    """``model``'s parameters (a module, or a dict of tensors by parameter
    name: the multi-seed sweep's stacked leaves) as optimizer groups:
    those under a prefix of ``frozen_prefixes`` (module paths, matched as
    the JAX package matches its '/'-joined ones: by ``startswith``) in a
    second group without weight decay.  A frozen tower detaches its
    output, so its parameters get no gradient and torch's SGD skips them;
    the group keeps weight decay off them all the same, as the JAX
    package's mask does, so a frozen leaf stays bit-unchanged with a zero
    momentum even where a gradient of zeros reaches it."""
    decayed, frozen = [], []
    named = (model.items() if isinstance(model, dict)
             else model.named_parameters())
    for name, param in named:
        (frozen if any(name.startswith(p) for p in frozen_prefixes)
         else decayed).append(param)
    groups = [{"params": decayed}]
    if frozen:
        groups.append({"params": frozen, "weight_decay": 0.0})
    return groups


def make_optimizer(params: Iterable, lr: float,
                   momentum: float = 0.9, weight_decay: float = 1.0e-4,
                   optimizer: str = "sgd") -> torch.optim.Optimizer:
    """The reference's per-variant optimizer.

    ``"sgd"``: torch.optim.SGD(momentum, weight_decay): weight decay is
    added to the gradient before the momentum buffer, whose first value is
    that gradient — the JAX package's add_decayed_weights -> trace chain.

    ``"adam"``: torch.optim.Adam's defaults, betas (0.9, 0.999), eps 1e-8
    outside the square root, weight decay 0 — what the four reference
    model files that train with Adam pass (only ``lr``); ``momentum`` and
    ``weight_decay`` are ignored, as in the JAX package's optax chain.

    ``params``: parameters, or groups (``decay_groups``)."""
    if optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.0)
    if optimizer != "sgd":
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           weight_decay=weight_decay)


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: torch.Tensor          # (M, C) fp32 EMA of batch-mean logits
    seed: int                  # seeds the per-step generator
    lr_schedule: Callable[[int], float]
    # Lightning's LearningRateMonitor names the LR stream after the torch
    # optimizer class (utils/run_trainer.py:20)
    lr_metric_name: str = "lr-SGD"
    # QMF History (existing_algos/QMF.py:12-29): (M, n_train) fp32 device
    # tensors under the qmf contract, else None
    qmf_correctness: Optional[torch.Tensor] = None
    qmf_confidence: Optional[torch.Tensor] = None
    # the data axis's process group that the steps' gradient sums run
    # over (``parallel/sharding.py::place_state``), None for one rank; the
    # leaves sharded over the mesh (TP, stage, FSDP: ``ShardedParams``),
    # else None
    data_axis: Optional[Any] = None
    sharded: Optional[Any] = None

    def step_generator(self) -> torch.Generator:
        return step_generator(self.seed, self.step)


_MASK64 = (1 << 64) - 1


def mixed_seed(seed: int, step: int, stream: int = 0) -> int:
    """A 64-bit generator seed from (seed, step, stream), every bit mixed
    (splitmix64's finaliser).  The CPU generator keeps only the low 32
    bits of its seed, so a seed that merely packs ``seed`` above ``step``
    would let every run seed draw the same stream."""
    z = ((seed & 0xFFFFFFFF) << 32 | (step & 0xFFFFFFFF)) ^ (
        (stream * 0x9E3779B97F4A7C15) & _MASK64)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def step_generator(seed: int, step: int) -> torch.Generator:
    """CPU generator for one step's random draws (the JAX step's
    ``fold_in(rng, step)``): the same draws whatever the device."""
    return torch.Generator().manual_seed(mixed_seed(seed, step))


def spec_lr_schedule(spec: ModelSpec, args: Any, steps_per_epoch: int,
                     lr_override: Optional[float] = None
                     ) -> Callable[[int], float]:
    """The run's schedule from the config and the spec's StepLR settings;
    ``lr_override`` pins the base rate (see ``create_train_state``)."""
    base_lr = float(args.learning_rate if lr_override is None
                    else lr_override)
    return make_lr_schedule(
        base_lr, bool(getattr(args, "use_scheduler", False)),
        steps_per_epoch, spec.sched_step_size, spec.sched_gamma,
        int(getattr(args, "num_epochs", 1)))


def create_train_state(spec: ModelSpec, args: Any, seed: int,
                       steps_per_epoch: int, device="cuda",
                       momentum: float = 0.9,
                       weight_decay: float = 1.0e-4,
                       optimizer: str = "sgd",
                       lr_override: Optional[float] = None) -> TrainState:
    """Draw ``spec.module``'s weights from ``seed``, move it to ``device``
    (channels_last), and build the optimizer, EMA and (under the qmf
    contract) History tables there.  ``optimizer``, ``momentum``,
    ``weight_decay`` and ``lr_override`` are the benchmark's
    ``opt_kwargs``: ``lr_override`` pins the base learning rate whatever
    the config's ``learning_rate`` (FakeNews hard-codes Adam at 1e-4,
    fakenews/model.py:18,230)."""
    device = resolve_device(device)
    model = init_weights(spec.module, torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last)
    schedule = spec_lr_schedule(spec, args, steps_per_epoch, lr_override)
    opt = make_optimizer(decay_groups(model, spec.frozen_prefixes),
                         schedule(0), momentum, weight_decay, optimizer)
    ema = torch.zeros(spec.num_modality, int(args.num_classes),
                      dtype=torch.float32, device=device)
    qmf_corr = qmf_conf = None
    if spec.contract == "qmf":
        qmf_corr, qmf_conf = init_history(spec.num_modality,
                                          spec.n_train_samples, device)
    return TrainState(step=0, model=model, optimizer=opt, ema=ema,
                      seed=seed, lr_schedule=schedule,
                      lr_metric_name=f"lr-{type(opt).__name__}",
                      qmf_correctness=qmf_corr, qmf_confidence=qmf_conf)
