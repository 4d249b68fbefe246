"""Train and eval steps: the five training contracts (port of
``multimodal_clinical_tpu/engine/steps.py``).

``train_step(state, batch) -> (state, metrics)`` updates ``state`` in
place: preprocess on the device, forward, the contract's loss, backward,
OGM-GE gradient modulation where the spec asks for it, SGD, then the EMA
calibration, the metrics and the QMF History scatter.
``eval_step(state, batch) -> outputs``.  Batches are dicts
``{"x1"|"x1_waveform", "x2", "label", "idx", "valid"}``; ``valid`` masks
the padding rows of fixed-size batches.  Metrics stay on the device:
reading them is the caller's synchronisation.

Under data parallelism (``parallel/``) each rank's batch is its rows of
the global batch.  After the forward every rank gathers the global
batch's model outputs, labels, masks and ids, its own rows kept live
(``global_rows``), and computes the contract's loss, the metrics, the EMA
and the QMF History on the global batch, as the JAX step does over its
data mesh; every rank's backward reaches only its own rows, so the sum of
the ranks' gradients (``sum_gradients``) is the global batch's gradient.
The OGM-GE modulation follows that sum, and the sharded leaves
(``state.sharded``: FSDP, and the model axis's leaves that do not compute
on their block) are gathered before the forward and keep their blocks
after.  The gathers of the global batch and the gradient sums run over
the state's data axis (``state.data_axis``) only, which the train step
also hands to the ops that see the global batch (global BatchNorm, the
dropout and SpecAugment draws) for its extent
(``parallel/distributed.py::data_axis``).  The ranks of one data
coordinate compute the same loss, so each leaf ends the backward with
the same gradient on all of them: a column-parallel Dense's block its own
(Megatron's f and g, ``parallel/sharding.py``), a stage's slice its
stage's, and every other leaf the whole gradient, because the pipeline's
backward hands stage 0's input gradient to every stage rank
(``parallel/pipeline.py``) and a sequence-sharded region sums its
leaves' gradients over the model axis (``models/siglip.py``).  For one
rank (None) none of this issues a collective.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..algos import ema as ema_lib
from ..algos import qmf as qmf_lib
from ..algos.ogm_ge import NoiseSource, device_noise, modulate_gradients
from ..algos.vicreg import vicreg_loss
from ..models.common import MaskSource, dropout_source
from ..parallel.distributed import (
    all_reduce_sum_, axis_group, data_axis, global_rows, group_size,
    rank_rows,
)
from . import contracts as C
from .spec import ModelSpec
from .state import TrainState, mixed_seed

Batch = Dict[str, torch.Tensor]


def _model_inputs(batch: Batch, spec: ModelSpec):
    n = spec.num_inputs or spec.num_modality
    return [batch[f"x{i + 1}"] for i in range(n)]


def history_of(state) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The QMF (correctness, confidence) tables of ``state``, or None."""
    if state.qmf_correctness is None:
        return None
    return state.qmf_correctness, state.qmf_confidence


def _per_sample_ce(logits, label):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, label[:, None].long())[:, 0]


def _min_loss_counts(logits, fused, label, valid):
    """Per-sample min-loss counters over {joint, x1, x2}
    (enrico/joint_model_counts.py:116-126)."""
    stack = torch.stack([_per_sample_ce(fused, label)]
                        + [_per_sample_ce(l, label) for l in logits])
    min_loss = stack.min(dim=0).values
    v = valid.float()
    counts = {"count_joint": ((stack[0] == min_loss) * v).sum()}
    for i in range(len(logits)):
        counts[f"count_x{i + 1}"] = ((stack[i + 1] == min_loss) * v).sum()
    return counts


def _qmf_terms(spec: ModelSpec, logits, label, valid, idx, corr_tab,
               conf_tab):
    """QMF loss terms and the updated History
    (cremad/joint_model_qmf.py:60-70)."""
    logits_df, conf = qmf_lib.df(torch.stack([l.float() for l in logits]))
    loss_uni = [C.cross_entropy(l, label, valid) for l in logits]
    updated = [qmf_lib.history_update(corr_tab[n], conf_tab[n], idx,
                                      loss_uni[n], conf[n], valid)
               for n in range(spec.num_modality)]
    new_corr = torch.stack([c for c, _ in updated])
    new_conf = torch.stack([f for _, f in updated])
    loss_reg = qmf_lib.reg_loss(conf, idx, new_corr, valid)
    loss_joint = C.cross_entropy(logits_df, label, valid)
    return logits_df, loss_joint, loss_uni, loss_reg, new_corr, new_conf


def _train_loss(spec: ModelSpec, history, batch: Batch, out,
                aux: Dict[str, Any]) -> torch.Tensor:
    """The contract's training loss; fills ``aux`` with reporting tensors.
    ``history``: the QMF (correctness, confidence) tables, or None."""
    logits = out["logits"]
    label, valid = batch["label"], batch["valid"]

    if spec.contract in ("jlogits", "ogm_ge"):
        fused = C.fuse_logits(logits)
        aux.update(report=logits, fused=fused)
        return C.cross_entropy(fused, label, valid)

    if spec.contract == "jprobas":
        fused = C.fuse_probas(logits)
        aux.update(report=C.to_logprobs(logits), fused=fused)
        return C.cross_entropy(fused, label, valid)

    if spec.contract == "ensemble":
        ce = [C.cross_entropy(l, label, valid) * spec.unimodal_loss_scale
              for l in logits]
        if spec.fusion_weights is not None:
            loss = sum(w * c for w, c in zip(spec.fusion_weights, ce))
        elif spec.ensemble_train_mean:
            loss = sum(ce) / len(ce)  # the legacy dirs' mean
        else:
            loss = sum(ce)  # EnsembleBaseModel's sum (BaseModel.py:353)
        if spec.vicreg_weight:
            v = vicreg_loss(out["embeddings"][0], out["embeddings"][1],
                            valid)
            loss = loss + spec.vicreg_weight * v
            aux["vicreg"] = v
        aux.update(report=logits,
                   fused=C.fuse_logits(logits, spec.fusion_weights))
        return loss

    if spec.contract == "qmf":
        fused = C.fuse_logits(logits)
        if spec.qmf_ablate_train:
            # qmf_ablate: train plain joint logits; df only for the metrics
            logits_df, _ = qmf_lib.df(torch.stack([l.float()
                                                   for l in logits]))
            aux.update(report=logits, fused=fused, logits_df=logits_df)
            return C.cross_entropy(fused, label, valid)
        logits_df, loss_joint, loss_uni, loss_reg, new_corr, new_conf = (
            _qmf_terms(spec, logits, label, valid, batch["idx"], *history))
        loss = loss_reg
        if not spec.qmf_drop_joint:
            loss = loss + loss_joint
        if not spec.qmf_drop_unimodal:
            loss = loss + sum(loss_uni)
        aux.update(report=logits, fused=fused, logits_df=logits_df,
                   new_corr=new_corr, new_conf=new_conf)
        return loss

    raise ValueError(f"unknown contract {spec.contract!r}")


def _train_metrics(spec: ModelSpec, ema: torch.Tensor, aux, loss, label,
                   valid) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (new_ema, metrics) from the step's ``ema``."""
    report = [r.detach() for r in aux["report"]]
    fused = aux["fused"].detach()
    metrics = {
        "train_loss": loss,
        "train_acc": C.accuracy(fused, label, valid),
        "valid_count": valid.float().sum(),
    }
    if spec.track_min_loss_counts:
        metrics.update(_min_loss_counts(report, fused, label, valid))

    if spec.contract == "ensemble":
        if spec.report_logprobs:
            metrics["train_acc"] = C.accuracy(C.fuse_probas(report), label,
                                              valid)
            report = C.to_logprobs(report)
        for i, r in enumerate(report):
            metrics[f"train_x{i + 1}_acc"] = C.accuracy(r, label, valid)
        if "vicreg" in aux:
            metrics["train_vicreg_loss"] = aux["vicreg"].detach()
        return ema, metrics

    # jlogits family: uncalibrated and EMA-calibrated unimodal accuracies
    # (BaseModel.py:77-89); the EMA is updated BEFORE its offset is read
    batch_means = torch.stack(
        [ema_lib.masked_batch_mean(r.float(), valid) for r in report])
    new_ema = ema_lib.ema_update(ema, batch_means)
    offset = ema_lib.ema_offset(new_ema)
    for i, r in enumerate(report):
        metrics[f"train_x{i + 1}_acc_uncal"] = C.accuracy(r, label, valid)
        metrics[f"train_x{i + 1}_acc"] = C.accuracy(
            r.float() + offset[i], label, valid)
    if spec.contract == "qmf":
        metrics["train_df_acc"] = C.accuracy(aux["logits_df"].detach(),
                                             label, valid)
    return new_ema, metrics


def device_dropout(seed: int, step: int) -> MaskSource:
    """Dropout keep masks drawn on each activation's device, one generator
    per device seeded from (seed, step) on its own stream, in the order
    the forward asks: a resumed run draws what the uninterrupted one did.
    Under data parallelism each mask is drawn at the global batch's shape
    and the rank keeps its rows, so any number of ranks draws the masks
    of one."""
    generators = {}

    def source(shape, keep_prob, device):
        gen = generators.get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(mixed_seed(seed, step, stream=2))
            generators[device] = gen
        group = axis_group()
        drawn = (shape[0] * group_size(group),) + tuple(shape[1:])
        return rank_rows(torch.rand(drawn, generator=gen, device=device)
                         < keep_prob, group)

    return source


def global_batch(batch: Batch, out: Dict, group) -> Tuple[Batch, Dict]:
    """The global batch's labels, masks, ids and model outputs from this
    rank's (``batch``, ``out``) over the data axis's ``group``, this
    rank's rows live; the inputs as they are.  The identity for one
    rank."""
    if group_size(group) == 1:
        return batch, out
    batch = dict(batch)
    for key in ("label", "valid", "idx"):
        if key in batch:
            batch[key] = global_rows(batch[key], group)
    out = {k: ([global_rows(t, group) for t in v]
               if isinstance(v, (list, tuple)) else global_rows(v, group))
           for k, v in out.items()}
    return batch, out


def sum_gradients(model: torch.nn.Module, group) -> None:
    """Sum every gradient over the data axis's ``group``, one collective
    per dtype over the flattened gradients; a no-op for one rank."""
    if group_size(group) == 1:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for param in model.parameters():
        if param.grad is not None:
            by_dtype.setdefault(param.grad.dtype, []).append(param.grad)
    for grads in by_dtype.values():
        flat = all_reduce_sum_(torch.cat([g.reshape(-1) for g in grads]),
                               group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view(g.shape))


def make_train_step(
    spec: ModelSpec,
    ogm_noise: Optional[Callable[[TrainState], NoiseSource]] = None,
    dropout: Optional[Callable[[TrainState], MaskSource]] = None,
) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict]]:
    """``ogm_noise(state)`` gives the step's OGM-GE noise source, by default
    ``device_noise(state.seed, state.step)``; ``dropout(state)`` its
    dropout masks, by default ``device_dropout(state.seed, state.step)``."""
    if ogm_noise is None:
        ogm_noise = lambda state: device_noise(state.seed, state.step)
    if dropout is None:
        dropout = lambda state: device_dropout(state.seed, state.step)
    modulate = bool(spec.apply_grad_mod and spec.grad_mod_type)

    def train_step(state: TrainState, batch: Batch):
        # the ops that see the global batch read the data axis from here
        with data_axis(state.data_axis):
            return _train_step(state, batch)

    def _train_step(state: TrainState, batch: Batch):
        if state.sharded is not None:
            state.sharded.gather()
        if spec.device_preprocess is not None:
            batch = spec.device_preprocess(batch, state.step_generator(), True)
        state.model.train()
        with dropout_source(dropout(state)):
            out = state.model(*_model_inputs(batch, spec))
        batch, out = global_batch(batch, out, state.data_axis)
        label, valid = batch["label"], batch["valid"]
        aux: Dict[str, Any] = {}
        loss = _train_loss(spec, history_of(state), batch, out, aux)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        sum_gradients(state.model, state.data_axis)
        if modulate:
            raw = out["logits"]
            modulate_gradients(state.model, raw[0], raw[1], label,
                               ogm_noise(state), alpha=spec.ogm_alpha,
                               modulation=spec.grad_mod_type, valid=valid)
        if state.sharded is not None:
            state.sharded.keep_grad_slices()
        for group in state.optimizer.param_groups:
            group["lr"] = state.lr_schedule(state.step)
        state.optimizer.step()
        if state.sharded is not None:
            state.sharded.release()
        with torch.no_grad():
            state.ema, metrics = _train_metrics(spec, state.ema, aux,
                                                loss.detach(), label, valid)
        if "new_corr" in aux:
            state.qmf_correctness = aux["new_corr"]
            state.qmf_confidence = aux["new_conf"]
        state.step += 1
        return state, metrics

    return train_step


def make_scan_train_step(spec: ModelSpec, k: int):
    """K optimizer steps per call (the JAX package's ``lax.scan`` device
    loop, ``make_scan_train_step``): exactly K sequential train steps, the
    same updates, EMA, QMF scatters and per-step generators.  Metrics come
    back stacked with a leading (K,) axis and the step counter advances by
    K."""
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


def eval_outputs(spec: ModelSpec, batch: Batch, out, history) -> Dict:
    """The eval step's outputs from the forward's ``out`` on the
    preprocessed ``batch``; ``history``: the QMF tables, or None."""
    label, valid = batch["label"], batch["valid"]
    logits = out["logits"]
    eval_vicreg = None

    eval_fusion = spec.eval_fusion or (
        "probas" if spec.contract == "jprobas" else "logits")
    if spec.contract == "jprobas" and eval_fusion == "probas":
        report = C.to_logprobs(logits)
        fused = C.fuse_probas(logits)
        loss = C.cross_entropy(fused, label, valid)
    elif spec.contract == "ensemble":
        # eval fuses the PLAIN mean for every ensemble variant and
        # averages the losses (BaseModel.py:410-412); the fusion
        # weights are train-only (mimic/ensemble_model.py:197-199)
        report = logits
        fused = C.fuse_logits(logits)
        ce = [C.cross_entropy(l, label, valid) * spec.unimodal_loss_scale
              for l in logits]
        if spec.vicreg_weight:
            # the vicreg variant evals the SUM of the unimodal losses
            # (enrico/ensemble_model_vicreg.py:211, 270)
            eval_vicreg = vicreg_loss(out["embeddings"][0],
                                      out["embeddings"][1], valid)
            loss = sum(ce) + spec.vicreg_weight * eval_vicreg
        else:
            loss = sum(ce) / len(ce)
    else:
        report = logits
        fused = C.fuse_logits(logits)
        loss = C.cross_entropy(fused, label, valid)

    outputs = {
        "logits_stack": torch.stack([r.float() for r in report], dim=1),
        "label": label,
        "valid": valid,
        "loss": loss,
        "acc": C.accuracy(fused, label, valid),
    }
    if eval_vicreg is not None:
        # the raw (unweighted) vicreg loss per val/test batch
        # (enrico/ensemble_model_vicreg.py:216, 268)
        outputs["vicreg_loss"] = eval_vicreg
    if spec.track_min_loss_counts:
        outputs.update(_min_loss_counts(logits, fused, label, valid))
    if spec.contract == "ensemble":
        rep = C.to_logprobs(report) if spec.report_logprobs else report
        for i, r in enumerate(rep):
            outputs[f"x{i + 1}_acc"] = C.accuracy(r, label, valid)
    if spec.contract == "qmf":
        logits_df, conf = qmf_lib.df(torch.stack([l.float()
                                                  for l in logits]))
        outputs["df_acc"] = C.accuracy(logits_df, label, valid)
        # the full QMF eval loss (joint + uni + reg), with NO scatter of
        # val/test rows into the History (the JAX package's documented
        # divergence from cremad/joint_model_qmf.py:62-65)
        if not spec.qmf_ablate_train:
            loss_uni = [C.cross_entropy(l, label, valid) for l in logits]
            loss_joint = C.cross_entropy(logits_df, label, valid)
            loss_reg = qmf_lib.reg_loss(conf, batch["idx"], history[0],
                                        valid)
            outputs["loss"] = loss_joint + sum(loss_uni) + loss_reg
    return outputs


def make_eval_step(spec: ModelSpec) -> Callable[[TrainState, Batch], Dict]:
    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch):
        if state.sharded is not None:
            state.sharded.gather()
        if spec.device_preprocess is not None:
            batch = spec.device_preprocess(batch, None, False)
        state.model.eval()
        out = state.model(*_model_inputs(batch, spec))
        batch, out = global_batch(batch, out, state.data_axis)
        return eval_outputs(spec, batch, out, history_of(state))

    return eval_step
