"""Train and eval steps (port of ``multimodal_clinical_tpu/engine/steps.py``,
the jprobas contract).

``train_step(state, batch) -> (state, metrics)`` updates ``state`` in
place: preprocess on the device, forward, loss, backward, SGD, then the
EMA calibration and the metrics.  ``eval_step(state, batch) -> outputs``.
Batches are dicts ``{"x1"|"x1_waveform", "x2", "label", "idx", "valid"}``;
``valid`` masks the padding rows of fixed-size batches.  Metrics stay on
the device: reading them is the caller's synchronisation.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..algos import ema as ema_lib
from . import contracts as C
from .spec import ModelSpec
from .state import TrainState

Batch = Dict[str, torch.Tensor]


def _model_inputs(batch: Batch, spec: ModelSpec):
    return [batch[f"x{i + 1}"] for i in range(spec.num_modality)]


def _train_metrics(state: TrainState, report, fused, loss, label, valid):
    """Returns (new_ema, metrics).  The EMA is updated BEFORE its offset
    is read (BaseModel.py:77-89)."""
    metrics = {
        "train_loss": loss,
        "train_acc": C.accuracy(fused, label, valid),
        "valid_count": valid.float().sum(),
    }
    batch_means = torch.stack(
        [ema_lib.masked_batch_mean(r.float(), valid) for r in report])
    new_ema = ema_lib.ema_update(state.ema, batch_means)
    offset = ema_lib.ema_offset(new_ema)
    for i, r in enumerate(report):
        metrics[f"train_x{i + 1}_acc_uncal"] = C.accuracy(r, label, valid)
        metrics[f"train_x{i + 1}_acc"] = C.accuracy(
            r.float() + offset[i], label, valid)
    return new_ema, metrics


def make_train_step(spec: ModelSpec
                    ) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict]]:
    def train_step(state: TrainState, batch: Batch):
        if spec.device_preprocess is not None:
            batch = spec.device_preprocess(batch, state.step_generator(), True)
        label, valid = batch["label"], batch["valid"]
        state.model.train()
        logits = state.model(*_model_inputs(batch, spec))["logits"]
        fused = C.fuse_probas(logits)
        loss = C.cross_entropy(fused, label, valid)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in state.optimizer.param_groups:
            group["lr"] = state.lr_schedule(state.step)
        state.optimizer.step()
        with torch.no_grad():
            report = C.to_logprobs([l.detach() for l in logits])
            state.ema, metrics = _train_metrics(
                state, report, fused.detach(), loss.detach(), label, valid)
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(spec: ModelSpec) -> Callable[[TrainState, Batch], Dict]:
    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch):
        if spec.device_preprocess is not None:
            batch = spec.device_preprocess(batch, None, False)
        label, valid = batch["label"], batch["valid"]
        state.model.eval()
        logits = state.model(*_model_inputs(batch, spec))["logits"]
        report = C.to_logprobs(logits)
        fused = C.fuse_probas(logits)
        return {
            "logits_stack": torch.stack([r.float() for r in report], dim=1),
            "label": label,
            "valid": valid,
            "loss": C.cross_entropy(fused, label, valid),
            "acc": C.accuracy(fused, label, valid),
        }

    return eval_step


def make_scan_train_step(spec: ModelSpec, k: int):
    """K optimizer steps per call (the JAX package's ``lax.scan`` device
    loop, ``make_scan_train_step``): exactly K sequential train steps, the
    same updates, EMA and per-step generators.  Metrics come back stacked
    with a leading (K,) axis and the step counter advances by K."""
    train_step = make_train_step(spec)

    def multi(state: TrainState, *batches: Batch):
        if len(batches) != k:
            raise ValueError(f"expected {k} batches, got {len(batches)}")
        per_step = []
        for batch in batches:
            state, metrics = train_step(state, batch)
            per_step.append(metrics)
        return state, {key: torch.stack([m[key] for m in per_step])
                       for key in per_step[0]}

    return multi
