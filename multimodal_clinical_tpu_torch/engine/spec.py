"""ModelSpec — the declarative description of one model variant (port of
``multimodal_clinical_tpu/engine/spec.py``, the fields the jprobas step and
the trainer read)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

# Training contracts (the five reference base classes, utils/BaseModel.py).
CONTRACTS = ("jlogits", "jprobas", "ensemble", "ogm_ge", "qmf")
# The port runs jprobas so far; the other four arrive with ROADMAP item A11.
PORTED_CONTRACTS = ("jprobas",)


def resolve_dtype(args) -> Optional[torch.dtype]:
    """Compute dtype from the ``compute_dtype`` config key: 'bfloat16' ->
    ``torch.bfloat16``; unset/'float32' -> None (modules compute in the
    input dtype).  Params and BN statistics stay fp32 either way."""
    name = getattr(args, "compute_dtype", None)
    if not name or str(name) == "float32":
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute_dtype {name!r}")
    return dtype


@dataclasses.dataclass
class ModelSpec:
    module: nn.Module
    contract: str = "jlogits"
    num_modality: int = 2
    # StepLR step_size (epochs) / gamma per model file
    sched_step_size: int = 70
    sched_gamma: float = 0.1
    # new-style dirs reload the top-1 val_avg_acc checkpoint before the
    # test epoch (utils/run_trainer.py:27-33,65); the legacy standalone
    # runners test the FINAL-epoch weights (vggsound/run_training.py:106-130)
    test_restore_best: bool = True
    # legacy standalone dirs also log FLAT epoch-end metric names
    # (val_loss / x{i}_val_acc / avg_test_acc ..., avmnist/joint_model.py:
    # 265-268) beside the val_epoch/* namespace
    legacy_metric_aliases: bool = False
    # (batch, generator, train) -> batch; runs inside the step
    device_preprocess: Optional[Callable] = None

    def __post_init__(self):
        if self.contract not in CONTRACTS:
            raise ValueError(f"unknown contract {self.contract!r}")
        if self.contract not in PORTED_CONTRACTS:
            raise NotImplementedError(
                f"contract {self.contract!r} is not ported yet "
                "(ROADMAP.md queue A, item 11: the other four contracts)")
