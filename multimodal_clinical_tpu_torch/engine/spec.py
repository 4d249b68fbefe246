"""ModelSpec — the declarative description of one model variant (port of
``multimodal_clinical_tpu/engine/spec.py``).

A ModelSpec names the module, the training contract and the per-variant
quirks (loss scales, fusion weights, scheduler parameters) that the
reference spreads across ``<ds>/joint_model*.py`` files and
``configure_optimizers`` overrides.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

# Training contracts (the five reference base classes, utils/BaseModel.py):
#   jlogits  — JointLogitsBaseModel:    CE on mean logits
#   jprobas  — JointProbLogitsBaseModel: CE on log-mean-softmax
#   ensemble — EnsembleBaseModel:       per-modality CE losses
#   ogm_ge   — OGMGEBaseModel:          jlogits + gradient modulation
#   qmf      — QMFBaseModel:            dynamic fusion + uni + ranking reg
CONTRACTS = ("jlogits", "jprobas", "ensemble", "ogm_ge", "qmf")


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
    # input-modality count when it differs from the logit-head count (the
    # fakenews embed-fusion model, fakenews/model.py:59-74); None means
    # num_modality
    num_inputs: Optional[int] = None

    # --- fusion variants ---
    # eval fusion of jprobas models: "probas" (default) or "logits" (the
    # jprobas_jlogits variants, avmnist/joint_model_proba_logits.py)
    eval_fusion: Optional[str] = None
    # ensemble TRAIN loss / train-metric fusion weights
    # (mimic/ensemble_model.py:157,160); eval fuses the plain mean
    fusion_weights: Optional[Sequence[float]] = None
    # per-modality CE scale (cremad/ensemble_model.py:54-55 uses 3.0)
    unimodal_loss_scale: float = 1.0
    # legacy ensemble dirs train on the MEAN of the per-modality losses
    # (ave/ensemble_model.py:115, vggsound/ensemble_model.py:114,
    # cremad/ensemble_model_noised.py:104); EnsembleBaseModel on the SUM
    # (utils/BaseModel.py:353)
    ensemble_train_mean: bool = False
    # new-style dirs reload the top-1 val_avg_acc checkpoint before the
    # test epoch (utils/run_trainer.py:27-33,65); the legacy standalone
    # runners test the FINAL-epoch weights (vggsound/run_training.py:106-130)
    test_restore_best: bool = True

    # --- OGM-GE (ogm_ge contract, or a hybrid) ---
    grad_mod_type: Optional[str] = None   # None|'OGM_GE'|'OGM'|'noise'
    ogm_alpha: float = 0.1
    # hybrids: OGM-GE on top of another contract
    # (cremad/ensemble_model_noised.py, cremad/joint_model_ogm_ge_lreg.py)
    apply_grad_mod: bool = False

    # --- QMF ---
    n_train_samples: int = 0        # sizes the History tables
    qmf_ablate_train: bool = False  # qmf_ablate: train plain jlogits, eval df
    qmf_drop_joint: bool = False    # ablate_Ljoint: loss_joint = 0
    qmf_drop_unimodal: bool = False  # ablate_Lunimodal: drop sum of L_uni

    # --- VICReg (enrico/ensemble_model_vicreg.py:151) ---
    vicreg_weight: float = 0.0

    # --- frozen towers: arrive with Enrico (ROADMAP.md queue A, item 14) ---
    frozen_prefixes: Tuple[str, ...] = ()

    # legacy standalone dirs also log FLAT epoch-end metric names
    # (val_loss / x{i}_val_acc / avg_test_acc ..., avmnist/joint_model.py:
    # 265-268) beside the val_epoch/* namespace
    legacy_metric_aliases: bool = False

    # --- analysis streams ---
    # per-sample min-loss counters over {joint, x1, x2}
    # (enrico/joint_model_counts.py:116-135)
    track_min_loss_counts: bool = False
    # ensemble trained on CE, metrics reported on log-probs
    # (avmnist/ensemble_model_probas.py:124-132)
    report_logprobs: bool = False

    # --- optimizer schedule (StepLR step_size/gamma per model file) ---
    sched_step_size: int = 70
    sched_gamma: float = 0.1

    # --- batching ---
    use_idx: bool = False  # batch carries global sample indices (QMF)

    # (batch, generator, train) -> batch; runs inside the step
    device_preprocess: Optional[Callable] = None

    def __post_init__(self):
        if self.contract not in CONTRACTS:
            raise ValueError(f"unknown contract {self.contract!r}")
        if self.frozen_prefixes:
            raise NotImplementedError(
                "frozen_prefixes is not ported yet (ROADMAP.md queue A, "
                "item 14: Enrico and the weight-decay mask)")
        if self.contract == "qmf" and self.n_train_samples <= 0:
            raise ValueError("qmf contract requires n_train_samples")
        if self.contract == "qmf":
            self.use_idx = True
        if self.contract == "ogm_ge":
            self.apply_grad_mod = True
            # an empty modulation would train as plain jlogits: default to
            # the reference's OGM_GE
            if not self.grad_mod_type:
                self.grad_mod_type = "OGM_GE"
