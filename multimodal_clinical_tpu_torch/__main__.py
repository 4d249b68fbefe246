"""``python -m multimodal_clinical_tpu_torch --dir <benchmark>``: the CLI of
``python -m multimodal_clinical_tpu`` (and the repository's ``main.py``)
for the port.  ``--set num_seeds=S`` trains seeds ``seed .. seed + S - 1``
as one multi-seed sweep (``engine/multiseed.py``) and writes their test
metrics to ``seeds.csv``.  ``--set dist_coordinator=host:port
dist_num_processes=N dist_process_id=r`` (or ``dist_init=True`` under
``torchrun``) trains with data parallelism over N processes, one device
each (``parallel/``).  It runs on the CUDA device; ``run_training(argv,
device="cpu")`` runs it on the CPU in process."""

from __future__ import annotations

from .benchmarks import get_benchmark
from .config import setup_configs
from .engine.run import run_benchmark
from .parallel.distributed import initialize_if_requested


def run_training(argv=None, device="cuda"):
    args = setup_configs(argv)
    # multi-process start-up first, as the JAX main.py:24-27 does; the
    # rank's own device from here on
    device = initialize_if_requested(args, device)
    benchmark = get_benchmark(args.dir)
    num_seeds = int(getattr(args, "num_seeds", 1) or 1)
    if num_seeds > 1:
        from .engine.multiseed import run_multiseed

        seeds = list(range(int(args.seed), int(args.seed) + num_seeds))
        summary = run_multiseed(args, benchmark, seeds, device=device)
    else:
        summary = run_benchmark(args, benchmark,
                                profile_dir=getattr(args, "profile_dir",
                                                    None),
                                device=device)
    print({k: round(v, 4) for k, v in summary.items()}, flush=True)
    return summary


if __name__ == "__main__":
    run_training()
