"""Enrico modality/label-noise sweep (port of the JAX package's
``tools/noise_sweep.py``): the reference's noise-experiment workflow
(enrico/get_data_noised.py + run_parallel.sh seed sweeps + make_graph.py
CSV artifacts) as one tool.

For each noise probability, trains ``num_seeds`` seeds together (the
port's multi-seed sweep, ``engine/multiseed.py::run_multiseed``) for each
requested model type and writes the reference's artifact shapes:

  data.csv     noise_p, <model>_joint_acc, <model>_joint_std, ...
  data_x1.csv  x1 (noised-modality) unimodal accuracies
  data_x2.csv  x2 (clean-modality) unimodal accuracies

matching enrico/data{,_x1,_x2}.csv (BASELINE.md rows: e.g. at label-noise
p=0.05 the reference reports ensemble 0.3459 / jlogits 0.4007 joint acc).
Trains on the CUDA device unless ``--device cpu``.

Usage:
  python -m multimodal_clinical_tpu_torch.tools.noise_sweep --mode x1 \
      --probs 0 0.05 0.1 --model-types jlogits ensemble --num-seeds 4 \
      --num-epochs 20 --out-dir runs/enrico_noise
"""

from __future__ import annotations

import argparse
import csv
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--mode", choices=["x1", "label"], default="x1",
                        help="x1 = cross-class screenshot swap; label = "
                             "label corruption (enrico/get_data_noised.py)")
    parser.add_argument("--probs", type=float, nargs="+",
                        default=[0.0, 0.05, 0.1, 0.2])
    parser.add_argument("--model-types", nargs="+",
                        default=["jlogits", "ensemble"])
    parser.add_argument("--num-seeds", type=int, default=4)
    parser.add_argument("--base-seed", type=int, default=0)
    parser.add_argument("--num-epochs", type=int, default=None)
    parser.add_argument("--out-dir", default="runs/enrico_noise")
    parser.add_argument("--device", default="cuda")
    args_cli = parser.parse_args(argv)

    from ..benchmarks import enrico
    from ..config import load_config
    from ..engine.multiseed import run_multiseed
    from ..utils.device import resolve_device

    device = resolve_device(args_cli.device)

    os.makedirs(args_cli.out_dir, exist_ok=True)
    seeds = list(range(args_cli.base_seed,
                       args_cli.base_seed + args_cli.num_seeds))

    # rows[p][model] = summary
    results = {}
    for p in args_cli.probs:
        results[p] = {}
        for model_type in args_cli.model_types:
            args = load_config("enrico", overrides={
                "model_type": model_type,
                "noise_p": p if args_cli.mode == "x1" else 0.0,
                "label_noise_p": p if args_cli.mode == "label" else 0.0,
                "ckpt_dir": os.path.join(args_cli.out_dir, "ckpts"),
                "group_name": f"noise_{args_cli.mode}_{p}_{model_type}",
            })
            if args_cli.num_epochs:
                args.num_epochs = args_cli.num_epochs
            print(f"[sweep] p={p} model={model_type} seeds={seeds}")
            results[p][model_type] = run_multiseed(args, enrico, seeds,
                                                   device=device)

    def write(stream_key: str, fname: str):
        path = os.path.join(args_cli.out_dir, fname)
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            header = ["noise_p"]
            for m in args_cli.model_types:
                header += [f"{m}_acc", f"{m}_std"]
            writer.writerow(header)
            for p in args_cli.probs:
                row = [p]
                for m in args_cli.model_types:
                    s = results[p][m]
                    row += [round(s.get(stream_key, float("nan")), 4),
                            round(s.get(stream_key + "_std",
                                        float("nan")), 4)]
                writer.writerow(row)
        print(f"[sweep] wrote {path}")

    write("test_epoch/test_avg_acc", "data.csv")
    write("test_epoch/test_avg_x1_acc", "data_x1.csv")
    write("test_epoch/test_avg_x2_acc", "data_x2.csv")
    render_png(args_cli.out_dir, args_cli.probs, args_cli.model_types,
               results)


def render_png(out_dir, probs, model_types, results):
    """make_graph.py-equivalent artifact (enrico/make_graph.py:46-62):
    accuracy-vs-noise errorbar curves for joint/x1/x2 streams of every
    model type, one combined PNG."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception as exc:  # headless-image safety
        print(f"[sweep] matplotlib unavailable ({exc}); skipping PNG")
        return
    streams = [
        ("test_epoch/test_avg_acc", "joint", "-o"),
        ("test_epoch/test_avg_x1_acc", "x1", "-^"),
        ("test_epoch/test_avg_x2_acc", "x2", "->"),
    ]
    plt.figure(figsize=(15, 8))
    for model in model_types:
        for key, tag, fmt in streams:
            means = [results[p][model].get(key, float("nan")) for p in probs]
            stds = [results[p][model].get(key + "_std", 0.0) for p in probs]
            plt.errorbar(probs, means, yerr=stds, fmt=fmt, capsize=5,
                         label=f"{tag} {model}")
    plt.title("Test Accuracy vs Noise Probability")
    plt.xlabel("Probability")
    plt.ylabel("Accuracy")
    plt.legend()
    plt.grid(True)
    path = os.path.join(out_dir, "noise_experiment_combined.png")
    plt.savefig(path)
    plt.close()
    print(f"[sweep] wrote {path}")


if __name__ == "__main__":
    main()
