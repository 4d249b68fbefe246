"""Best-checkpoint management: save top-1 on val accuracy, reload before
test (port of ``multimodal_clinical_tpu/engine/checkpoint.py``).

Mirrors the reference flow (utils/run_trainer.py:23-33, 65): a single best
checkpoint keyed on ``val_epoch/val_avg_acc`` (max, strictly greater),
reloaded before the test pass where the benchmark asks for it.  The FULL
train state is saved with ``torch.save``: the model's parameters and BN
buffers, the optimizer (momentum), the EMA calibration, the QMF History
tables, the step and the seed, so training also resumes exactly,
mid-epoch included.

Layout, as the JAX package writes it:

    <ckpt_dir>/best            top-1 on the tracked metric
    <ckpt_dir>/last-<step>     rolling exact-resume checkpoints, pruned to
                               ``keep_last``
    <ckpt_dir>/meta.json       best metric and resume bookkeeping

Under several ranks every rank computes the tree (the sharded leaves'
blocks gathered for it: TP, stage slices, FSDP), rank 0 alone writes,
and every rank reads a checkpoint after a barrier (the JAX package's
primary-process writes).

Each checkpoint is a directory holding ``state.pt``.  A save writes
``<name>.pending/state.pt`` (through a temporary file and a rename, so the
file exists only once complete), then swaps the pending directory over
``<name>``.  A crash before the file is complete leaves an uncommitted
pending directory and the old checkpoint intact; a crash during the swap
leaves a committed one.  ``_recover_pending`` promotes the committed and
sweeps the rest when the next checkpointer opens the directory.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional

import torch

from ..parallel.distributed import barrier, is_primary
from .state import TrainState

STATE_FILE = "state.pt"
PENDING = ".pending"


def state_to_tree(state: TrainState) -> Dict[str, Any]:
    """The full train state; its sharded leaves (TP, stage, FSDP)
    gathered whole (a collective: every rank calls it)."""
    sharded = getattr(state, "sharded", None)
    return {
        "step": int(state.step),
        "model": (state.model.state_dict() if sharded is None else
                  sharded.full_model_state(state.model)),
        "optimizer": (state.optimizer.state_dict() if sharded is None else
                      sharded.full_optimizer_state(state.optimizer)),
        "ema": state.ema,
        "seed": int(state.seed),
        "qmf_correctness": state.qmf_correctness,
        "qmf_confidence": state.qmf_confidence,
    }


def tree_into_state(state: TrainState, tree: Dict[str, Any],
                    weights_only: bool = False) -> TrainState:
    """Load ``tree`` into ``state`` in place; ``weights_only`` takes the
    model's parameters and BN buffers only (a warm start)."""
    sharded = getattr(state, "sharded", None)
    if sharded is None:
        state.model.load_state_dict(tree["model"])
    else:
        sharded.load_full_model_state(state.model, tree["model"])
    if weights_only:
        return state
    if sharded is None:
        state.optimizer.load_state_dict(tree["optimizer"])
    else:
        sharded.load_full_optimizer_state(state.optimizer, tree["optimizer"])
    device = state.ema.device
    state.ema = tree["ema"].to(device)
    for key in ("qmf_correctness", "qmf_confidence"):
        table = tree.get(key)
        setattr(state, key, None if table is None else table.to(device))
    state.step = int(tree["step"])
    state.seed = int(tree["seed"])
    return state


class BestCheckpointer:
    """Keeps the best checkpoint by a max-metric plus a pruned rolling
    tail."""

    def __init__(self, ckpt_dir: str, keep_last: int = 2) -> None:
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.best_metric: float = float("-inf")
        self.best_path: Optional[str] = None
        # resume bookkeeping: epochs completed at save time and the epoch
        # geometry they were measured in (the trainer guards on both);
        # meta_step stamps which checkpoint step the metadata describes, so
        # resume trusts epochs_done only when it matches the restored step
        self.epochs_done: Optional[int] = None
        self.steps_per_epoch: Optional[int] = None
        self.meta_step: Optional[int] = None
        # batches already consumed within epoch `epochs_done` at save time
        # (0 for epoch-boundary saves): mid-epoch exact resume
        self.steps_into_epoch: int = 0
        self.keep_last = max(1, int(keep_last))
        self._primary = is_primary()
        if self._primary:
            os.makedirs(self.ckpt_dir, exist_ok=True)
            self._recover_pending()

    # -- commit plumbing -------------------------------------------------
    @staticmethod
    def _committed(path: str) -> bool:
        return os.path.isfile(os.path.join(path, STATE_FILE))

    def _recover_pending(self) -> None:
        """Crash recovery: a committed '<name>.pending' dir is a save that
        finished before its swap: promote it; sweep uncommitted debris."""
        for name in sorted(os.listdir(self.ckpt_dir)):
            if not name.endswith(PENDING):
                continue
            tmp = os.path.join(self.ckpt_dir, name)
            final = tmp[: -len(PENDING)]
            if self._committed(tmp):
                if os.path.isdir(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
            else:
                shutil.rmtree(tmp, ignore_errors=True)

    def _save(self, path: str, tree: Dict[str, Any]) -> None:
        if self._primary:
            self._write(path, tree)
        barrier()

    def _write(self, path: str, tree: Dict[str, Any]) -> None:
        tmp = path + PENDING
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        part = os.path.join(tmp, STATE_FILE + ".part")
        torch.save(tree, part)
        os.replace(part, os.path.join(tmp, STATE_FILE))  # commit
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)

    def _restore(self, path: str, device) -> Dict[str, Any]:
        return torch.load(os.path.join(path, STATE_FILE),
                          map_location=device, weights_only=True)

    # -- metadata ---------------------------------------------------------
    def _write_meta(self) -> None:
        if not self._primary:
            return
        with open(os.path.join(self.ckpt_dir, "meta.json"), "w") as f:
            json.dump({"best_metric": self.best_metric,
                       "epochs_done": self.epochs_done,
                       "steps_per_epoch": self.steps_per_epoch,
                       "steps_into_epoch": self.steps_into_epoch,
                       "meta_step": self.meta_step}, f)

    def _read_meta(self) -> None:
        path = os.path.join(self.ckpt_dir, "meta.json")
        if os.path.exists(path):
            with open(path) as f:
                meta = json.load(f)
            self.best_metric = float(meta["best_metric"])
            self.epochs_done = meta.get("epochs_done")
            self.steps_per_epoch = meta.get("steps_per_epoch")
            self.steps_into_epoch = int(meta.get("steps_into_epoch") or 0)
            self.meta_step = meta.get("meta_step")
            # a best metric whose checkpoint is not there (a crash inside
            # the save's swap): forget it so maybe_save saves again
            if not self._committed(os.path.join(self.ckpt_dir, "best")):
                self.best_metric = float("-inf")

    # -- public API --------------------------------------------------------
    def maybe_save(self, state: TrainState, metric: float) -> bool:
        """Save iff ``metric`` improves on the best so far; returns True if
        saved."""
        if metric <= self.best_metric:
            return False
        self.best_metric = metric
        path = os.path.join(self.ckpt_dir, "best")
        self._save(path, state_to_tree(state))
        self.best_path = path
        self._write_meta()
        return True

    def _last_candidates(self):
        """[(step, path)] of rolling checkpoints, oldest first."""
        out = []
        if not os.path.isdir(self.ckpt_dir):
            return out
        for name in os.listdir(self.ckpt_dir):
            m = re.fullmatch(r"last-(\d+)", name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.ckpt_dir, name)))
        return sorted(out)

    def save_last(self, state: TrainState,
                  epochs_done: Optional[int] = None,
                  steps_per_epoch: Optional[int] = None,
                  steps_into_epoch: int = 0) -> str:
        """Step-stamped rolling checkpoint; prunes beyond ``keep_last``.

        ``steps_into_epoch`` > 0 marks a MID-epoch save: ``epochs_done``
        epochs are complete plus that many batches of the next one (the
        trainer's ``ckpt_every_n_steps`` and preemption paths)."""
        step = int(state.step)
        path = os.path.join(self.ckpt_dir, f"last-{step}")
        if epochs_done is not None:
            self.epochs_done = int(epochs_done)
            self.steps_per_epoch = (int(steps_per_epoch)
                                    if steps_per_epoch else None)
            self.steps_into_epoch = int(steps_into_epoch)
            self.meta_step = step
            self._write_meta()
        candidates = [p for _, p in self._last_candidates() if p != path]
        keep_prior = self.keep_last - 1
        if self._primary:
            for stale in (candidates[:-keep_prior] if keep_prior
                          else candidates):
                shutil.rmtree(stale)
        self._save(path, state_to_tree(state))
        return path

    def restore_last(self, state: TrainState, weights_only: bool = False
                     ) -> Optional[TrainState]:
        """Restore the state from the newest rolling checkpoint for exact
        resume (model, optimizer, EMA, QMF tables, step, seed).  None if there is no
        checkpoint.  A torn newest checkpoint falls back to an older one."""
        barrier()  # every rank lists what rank 0 has written
        candidates = self._last_candidates()
        if not candidates:
            return None
        device = state.ema.device
        errors = []
        for _, path in reversed(candidates):
            try:
                tree = self._restore(path, device)
                break
            except (OSError, RuntimeError, EOFError) as exc:
                errors.append((path, exc))
        else:
            raise RuntimeError(f"all rolling checkpoints unreadable: {errors}")
        if errors:
            print(f"[checkpoint] WARNING: skipped unreadable {errors[0][0]} "
                  f"({errors[0][1]}); resumed from {path}")
        self._read_meta()
        return tree_into_state(state, tree, weights_only)

    def restore_best(self, state: TrainState, weights_only: bool = False
                     ) -> TrainState:
        """Load the best checkpoint into ``state``; ``state`` unchanged
        when there is none."""
        barrier()
        if self.best_path is None:
            candidate = os.path.join(self.ckpt_dir, "best")
            if not self._committed(candidate):
                return state
            self.best_path = candidate
        tree = self._restore(self.best_path, state.ema.device)
        return tree_into_state(state, tree, weights_only)

    def has_checkpoint(self) -> bool:
        barrier()
        return bool(self._last_candidates()) or self._committed(
            os.path.join(self.ckpt_dir, "best"))
