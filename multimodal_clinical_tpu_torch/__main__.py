"""``python -m multimodal_clinical_tpu_torch --dir <benchmark>``: the CLI of
``python -m multimodal_clinical_tpu`` (and the repository's ``main.py``)
for the port.  It runs on the CUDA device; ``run_training(argv,
device="cpu")`` runs it on the CPU in process."""

from __future__ import annotations

from .benchmarks import get_benchmark
from .config import setup_configs
from .engine.run import run_benchmark


def run_training(argv=None, device="cuda"):
    args = setup_configs(argv)
    benchmark = get_benchmark(args.dir)
    num_seeds = int(getattr(args, "num_seeds", 1) or 1)
    if num_seeds > 1:
        raise NotImplementedError(
            "num_seeds > 1: the multi-seed sweep is not ported yet "
            "(ROADMAP.md queue A, item 17)")
    summary = run_benchmark(args, benchmark,
                            profile_dir=getattr(args, "profile_dir", None),
                            device=device)
    print({k: round(v, 4) for k, v in summary.items()}, flush=True)
    return summary


if __name__ == "__main__":
    run_training()
