"""The training engine: epoch loop, eval, best-checkpoint, test (port of
``multimodal_clinical_tpu/engine/trainer.py``).

Fit over epochs with per-step metric streams, epoch-end validation with
full-epoch offset correction, top-1 checkpoint on ``val_epoch/val_avg_acc``
(max), then the test pass (utils/run_trainer.py:6-70), plus step-time and
samples-per-second telemetry and an optional ``torch.profiler`` trace.

The loop only moves batches (prefetched by the Loader) and keeps each
step's metrics on the device: they are read at a ``log_every_n_steps`` row
and at the epoch's end, so the host does not wait for the card every step.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from ..parallel.distributed import is_primary, world_size
from ..utils.logging import RunLogger
from .checkpoint import BestCheckpointer
from .metrics import (
    EpochAccumulator,
    eval_epoch_summary,
    legacy_alias_summary,
    step_metric_name,
    to_host,
    train_epoch_summary,
)
from .spec import ModelSpec
from .state import TrainState
from .steps import make_eval_step, make_scan_train_step, make_train_step


class Preempted(SystemExit):
    """Raised after a SIGTERM-triggered checkpoint: the state is on disk and
    the process should exit (``--resume`` continues mid-epoch exactly)."""

    def __init__(self, step: int) -> None:
        super().__init__(143)  # conventional SIGTERM exit status
        self.step = step


class _FixedBatches:
    """Fixed set of already-placed device batches standing in for a Loader.

    Backs the ``overfit_batches`` sanity mode (reference
    utils/run_trainer.py:6,54): train AND validate on the same first-k
    train batches."""

    def __init__(self, batches) -> None:
        self.batches = list(batches)

    def set_epoch(self, epoch: int) -> None:  # same subset every epoch
        pass

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _sync(state: TrainState) -> None:
    if state.ema.device.type == "cuda":
        torch.cuda.synchronize(state.ema.device)


class Trainer:
    def __init__(
        self,
        args: Any,
        spec: ModelSpec,
        state: TrainState,
        train_loader,
        val_loader,
        test_loader,
        run_dir: Optional[str] = None,
        logger: Optional[RunLogger] = None,
        profile_dir: Optional[str] = None,
    ) -> None:
        self.args = args
        self.spec = spec
        self.state = state
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.test_loader = test_loader

        data_path = str(getattr(args, "data_path", "runs")).rstrip("/")
        group = getattr(args, "group_name", "run")
        self.run_dir = run_dir or os.path.join(
            getattr(args, "ckpt_dir", None) or f"{data_path}_ckpts", str(group)
        )
        # under data parallelism rank 0 alone writes the run's files
        primary = is_primary()
        if primary:
            os.makedirs(self.run_dir, exist_ok=True)
        self.logger = logger or RunLogger(
            self.run_dir, use_wandb=bool(getattr(args, "use_wandb", False)),
            wandb_config=vars(args) if hasattr(args, "__dict__") else None,
            group_name=str(group), write=primary)
        self.ckpt = BestCheckpointer(os.path.join(self.run_dir, "ckpt"))
        self.train_step = make_train_step(spec)
        self.eval_step = make_eval_step(spec)
        # K optimizer steps per call; tail batches take single steps
        self.steps_per_dispatch = int(
            getattr(args, "steps_per_dispatch", 1) or 1)
        if self.steps_per_dispatch > 1:
            self.scan_train_step = make_scan_train_step(
                spec, self.steps_per_dispatch)
        self.log_every = int(getattr(args, "log_every_n_steps", 30) or 0)
        # mid-epoch rolling checkpoints every N optimizer steps (0 = off)
        self.ckpt_every = int(getattr(args, "ckpt_every_n_steps", 0) or 0)
        # Lightning semantics (run_trainer.py:54): float in (0, 1] = that
        # fraction of the train batches, int >= 1 = that many batches
        self.overfit_batches = getattr(args, "overfit_batches", 0) or 0
        self.profile_dir = profile_dir
        self.history: List[Dict[str, float]] = []
        # SIGTERM sets this flag; fit() checks it at step boundaries, saves
        # a mid-epoch exact-resume checkpoint and exits
        self._preempt_requested = False
        self._eval_pass = -1

    # ------------------------------------------------------------------
    def _run_eval(self, loader, prefix: str) -> Dict[str, float]:
        # tick the eval loader's epoch so per-(seed, epoch, index) draws
        # re-randomise each pass like the reference's stateful transforms
        self._eval_pass += 1
        loader.set_epoch(self._eval_pass)
        outputs = [self.eval_step(self.state, batch) for batch in loader]
        if not outputs:
            return {}
        outputs = [{k: to_host(v) for k, v in o.items()} for o in outputs]
        if self.log_every:
            # per-batch eval streams under the reference's step namespace
            # (BaseModel.py:158-159, 227-228), logged after the pass from
            # the collected outputs, all at the current global step
            base = int(self.state.step)
            for o in outputs:
                row = {f"{prefix}_step/{prefix}_acc": float(o["acc"]),
                       f"{prefix}_step/{prefix}_loss": float(o["loss"])}
                if "df_acc" in o:
                    row[f"{prefix}_step/logits_df_acc"] = float(o["df_acc"])
                if "vicreg_loss" in o:
                    row[f"{prefix}_step/{prefix}_vicreg_loss"] = float(
                        o["vicreg_loss"])
                self.logger.log(row, step=base)
        summary = eval_epoch_summary(outputs, prefix)
        if self.spec.legacy_metric_aliases:
            summary.update(legacy_alias_summary(summary, prefix))
        return summary

    def resume(self) -> bool:
        """Restore the full train state from the rolling 'last' checkpoint.
        Returns True if a checkpoint was found."""
        restored = self.ckpt.restore_last(self.state)
        if restored is None:
            return False
        self.state = restored
        print(f"[trainer] resumed from step {int(self.state.step)} "
              f"(best={self.ckpt.best_metric:.4f})")
        return True

    def _enter_overfit_mode(self) -> None:
        """Pin the first-k train batches as both train and val loaders."""
        n_batches = max(len(self.train_loader), 1)
        raw = self.overfit_batches
        if isinstance(raw, float) and raw <= 1.0:
            k = max(1, round(raw * n_batches))
        else:
            k = max(1, int(raw))
        self.train_loader.set_epoch(0)
        batches = []
        for batch in self.train_loader:
            batches.append(batch)
            if len(batches) >= k:
                break
        fixed = _FixedBatches(batches)
        self.train_loader = fixed
        self.val_loader = fixed
        print(f"[trainer] overfit_batches={raw}: training AND validating on "
              f"the same {len(batches)} fixed train batch(es)")

    def _handle_preempt_signal(self, signum, frame) -> None:
        print("[trainer] SIGTERM: will checkpoint at the next step boundary "
              "and exit (resume with --resume)")
        self._preempt_requested = True

    def _preempt_exit(self, epoch: int, steps_per_epoch: int,
                      into_epoch: int) -> None:
        self.ckpt.save_last(self.state, epochs_done=epoch,
                            steps_per_epoch=steps_per_epoch,
                            steps_into_epoch=into_epoch)
        step = int(self.state.step)
        print(f"[trainer] preempted: exact-resume checkpoint saved at step "
              f"{step} (epoch {epoch} + {into_epoch} batches)")
        raise Preempted(step)

    def fit(self) -> Dict[str, float]:
        # SIGTERM checkpoints then exits.  Only the main thread may install
        # handlers; elsewhere training runs without the hook.
        installed = None
        if threading.current_thread() is threading.main_thread():
            installed = signal.signal(signal.SIGTERM,
                                      self._handle_preempt_signal)
        try:
            return self._fit_inner()
        finally:
            if installed is not None:
                signal.signal(signal.SIGTERM, installed)

    def _log_step_row(self, metrics: Dict, global_step: int,
                      advanced: int) -> None:
        keys = [k for k in metrics if k != "valid_count"]
        # one device->host read for the whole row
        means = torch.stack([metrics[k].float().mean() for k in keys])
        row = {step_metric_name("train", k): v
               for k, v in zip(keys, means.tolist())}
        # LearningRateMonitor parity (run_trainer.py:20): the LR the step
        # that just ran used
        row[self.state.lr_metric_name] = float(
            self.state.lr_schedule(global_step - advanced))
        self.logger.log(row, step=global_step)

    def _fit_inner(self) -> Dict[str, float]:
        num_epochs = int(getattr(self.args, "num_epochs", 1))
        if self.overfit_batches:
            self._enter_overfit_mode()
        steps_per_epoch = max(len(self.train_loader), 1)
        # Resume epoch: the recorded epochs_done when the metadata matches
        # the restored step, else the step-derived estimate
        meta_consistent = (self.ckpt.meta_step is None
                           or self.ckpt.meta_step == int(self.state.step))
        skip_batches = 0
        if self.ckpt.epochs_done is not None and meta_consistent:
            start_epoch = int(self.ckpt.epochs_done)
            if (self.ckpt.steps_per_epoch
                    and self.ckpt.steps_per_epoch != steps_per_epoch):
                print(f"[trainer] WARNING: epoch geometry changed since the "
                      f"checkpoint ({self.ckpt.steps_per_epoch} -> "
                      f"{steps_per_epoch} steps/epoch); resuming at epoch "
                      f"{start_epoch} from the recorded epoch count"
                      + (f"; the checkpoint's {self.ckpt.steps_into_epoch} "
                         f"mid-epoch batch(es) will be REPLAYED under the "
                         f"new geometry (resume is no longer exact)"
                         if self.ckpt.steps_into_epoch else ""))
            else:
                # mid-epoch save: the first resumed epoch replays its index
                # stream and skips the batches the checkpoint already saw
                skip_batches = int(self.ckpt.steps_into_epoch or 0)
        else:
            start_epoch = int(self.state.step) // steps_per_epoch
            skip_batches = int(self.state.step) % steps_per_epoch
        global_step = int(self.state.step)
        # profile the run's SECOND epoch when there is one (the first pays
        # the warm-up), else its only epoch
        profile_epoch = (start_epoch + 1
                         if num_epochs - start_epoch > 1 else start_epoch)
        last_val: Dict[str, float] = {}
        world = world_size()  # samples count the global batch's rows
        for epoch in range(start_epoch, num_epochs):
            self.train_loader.set_epoch(epoch)
            acc = EpochAccumulator()
            tic = time.perf_counter()
            samples = 0
            profiler = None
            if self.profile_dir is not None and epoch == profile_epoch:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if self.state.ema.device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
            pending = []
            into_epoch = 0
            if epoch == start_epoch and skip_batches:
                print(f"[trainer] mid-epoch resume: skipping the first "
                      f"{skip_batches} already-trained batch(es) of epoch "
                      f"{epoch}")
                into_epoch = skip_batches
            if into_epoch and hasattr(self.train_loader, "skip"):
                # index-level skip: the skipped batches are never gathered
                # or copied
                self.train_loader.skip(into_epoch)
                batch_iter = iter(self.train_loader)
            else:
                batch_iter = iter(self.train_loader)
                for _ in range(into_epoch):
                    if next(batch_iter, None) is None:
                        break
            for batch in batch_iter:
                if self.steps_per_dispatch > 1:
                    pending.append(batch)
                    if len(pending) < self.steps_per_dispatch:
                        continue
                    self.state, metrics = self.scan_train_step(
                        self.state, *pending)
                    samples += sum(b["label"].shape[0]
                                   for b in pending) * world
                    advanced = len(pending)
                    global_step += advanced
                    pending = []
                else:
                    self.state, metrics = self.train_step(self.state, batch)
                    samples += batch["label"].shape[0] * world
                    advanced = 1
                    global_step += 1
                acc.append(metrics)
                # crossing test: with K-step dispatch global_step moves in
                # strides of K
                if self.log_every and global_step % self.log_every < advanced:
                    self._log_step_row(metrics, global_step, advanced)
                into_epoch += advanced
                if self._preempt_requested:
                    self._preempt_exit(epoch, steps_per_epoch, into_epoch)
                if (self.ckpt_every and into_epoch < steps_per_epoch
                        and global_step % self.ckpt_every < advanced):
                    # the epoch's final step is covered by the epoch-
                    # boundary save below
                    self.ckpt.save_last(
                        self.state, epochs_done=epoch,
                        steps_per_epoch=steps_per_epoch,
                        steps_into_epoch=into_epoch)
            for batch in pending:  # tail shorter than K: single steps
                self.state, metrics = self.train_step(self.state, batch)
                acc.append(metrics)
                samples += batch["label"].shape[0] * world
                global_step += 1
                into_epoch += 1
                if self._preempt_requested:
                    self._preempt_exit(epoch, steps_per_epoch, into_epoch)
            if profiler is not None:
                _sync(self.state)
                profiler.stop()
                if is_primary():
                    os.makedirs(self.profile_dir, exist_ok=True)
                    profiler.export_chrome_trace(os.path.join(
                        self.profile_dir, f"trace_epoch{epoch}.json"))
            # the epoch's one wait for the card: the metric streams' fetch
            epoch_summary = train_epoch_summary(acc)
            wall = time.perf_counter() - tic
            epoch_summary["train_epoch/samples_per_sec"] = samples / max(
                wall, 1e-9)
            epoch_summary["train_epoch/epoch_time_sec"] = wall
            # the LR in effect after this epoch, under Lightning's key
            epoch_summary[self.state.lr_metric_name] = float(
                self.state.lr_schedule(global_step))

            val_summary = self._run_eval(self.val_loader, "val")
            last_val = val_summary
            self.logger.log_epoch({**epoch_summary, **val_summary}, epoch,
                                  step=global_step)
            self.history.append({**epoch_summary, **val_summary})

            val_acc = val_summary.get("val_epoch/val_avg_acc")
            if val_acc is not None:
                self.ckpt.maybe_save(self.state, val_acc)
            self.ckpt.save_last(self.state, epochs_done=epoch + 1,
                                steps_per_epoch=steps_per_epoch)
        return last_val

    def test(self, restore_best: bool = True) -> Dict[str, float]:
        """Optionally reload the best-val checkpoint, then run the test
        epoch (run_trainer.py:65-70)."""
        if restore_best:
            self.state = self.ckpt.restore_best(self.state)
        summary = self._run_eval(self.test_loader, "test")
        self.logger.log_epoch(summary, epoch=-1)
        return summary

