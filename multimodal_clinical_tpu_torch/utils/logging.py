"""Run logging: stdout and JSONL (port of
``multimodal_clinical_tpu/utils/logging.py``).

Every metric dict is appended to ``metrics.jsonl`` in the run directory as
the JAX package writes it, and epoch rows are mirrored to stdout.  The
port does not log to Weights & Biases: a config with ``use_wandb`` set
raises instead of training without it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class RunLogger:
    def __init__(self, run_dir: str, use_wandb: bool = False) -> None:
        if use_wandb:
            raise NotImplementedError(
                "use_wandb: the port logs to metrics.jsonl only")
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")

    def log(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        record = {"_time": time.time()}
        if step is not None:
            record["_step"] = int(step)
        record.update({k: _jsonable(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def log_epoch(self, metrics: Dict[str, float], epoch: int,
                  step: Optional[int] = None) -> None:
        self.log(dict(metrics, epoch=epoch), step=step)
        parts = "  ".join(f"{k.split('/')[-1]}={v:.4f}"
                          for k, v in sorted(metrics.items())
                          if isinstance(v, float))
        print(f"[epoch {epoch}] {parts}", flush=True)

    def close(self) -> None:
        self._jsonl.close()


def _jsonable(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
