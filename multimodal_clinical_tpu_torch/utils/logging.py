"""Run logging: stdout and JSONL (port of
``multimodal_clinical_tpu/utils/logging.py``).

Every metric dict is appended to ``metrics.jsonl`` in the run directory as
the JAX package writes it, and epoch rows are mirrored to stdout; with
``use_wandb`` set and the wandb package importable, metrics are mirrored
there too, and where it is not the run warns and goes on.  Under data
parallelism only rank 0 writes (``write=False`` elsewhere), where the JAX
logger appends from every process.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional


class RunLogger:
    def __init__(self, run_dir: str, use_wandb: bool = False,
                 wandb_config: Optional[Dict[str, Any]] = None,
                 group_name: str = "run", write: bool = True) -> None:
        self.run_dir = run_dir
        self.write = write
        self._jsonl = None
        self._wandb = None
        if not write:
            return
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        if use_wandb:
            try:
                import wandb  # type: ignore

                self._wandb = wandb.init(
                    project="multimodal_clinical_tpu", group=group_name,
                    config=wandb_config or {})
            except Exception as exc:  # no package / no network
                print(f"[logger] wandb disabled ({exc})", file=sys.stderr)

    def log(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        if not self.write:
            return
        record = {"_time": time.time()}
        if step is not None:
            record["_step"] = int(step)
        record.update({k: _jsonable(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_epoch(self, metrics: Dict[str, float], epoch: int,
                  step: Optional[int] = None) -> None:
        if not self.write:
            return
        self.log(dict(metrics, epoch=epoch), step=step)
        parts = "  ".join(f"{k.split('/')[-1]}={v:.4f}"
                          for k, v in sorted(metrics.items())
                          if isinstance(v, float))
        print(f"[epoch {epoch}] {parts}", flush=True)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()


def _jsonable(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
