"""Offline run analysis (port of the JAX package's
``tools/analyze_runs.py``): the reference's W&B-export CSV layout from the
port's run artifacts, and its cross-variant comparison.

The reference's statistical workflow exports 50-seed W&B runs to CSV
(mimic/mimic_{ensemble,jlogits}.csv) and compares variants offline
(mimic/analyze_data.py:4-23).  The port logs locally (``seeds.csv`` from
the multi-seed sweep, ``metrics.jsonl`` from the trainer's RunLogger);
this tool converts those artifacts into the reference's export column
layout and reproduces the analyze_data.py comparison, byte for byte as
the JAX tool writes them.  Host code only; no device.

Usage:
  python -m multimodal_clinical_tpu_torch.tools.analyze_runs export \
      --run-dir runs/x_ckpts/g1 --out a.csv
  python -m multimodal_clinical_tpu_torch.tools.analyze_runs compare \
      --jlogits jl.csv --ensemble en.csv
"""

from __future__ import annotations

import argparse
import csv
import json
import os

# our metric namespace -> the reference's W&B export column
# (mimic/mimic_jlogits.csv header; BaseModel.py:262-267 log names)
COLUMN_MAP = [
    ("test_epoch/test_avg_acc", "test_acc_epoch"),
    ("test_epoch/test_avg_acc", "avg_test_acc"),
    ("test_epoch/test_avg_loss", "test_loss_epoch"),
    ("test_epoch/test_avg_loss", "avg_test_loss"),
    ("test_epoch/test_avg_x1_acc", "x1_test_acc"),
    ("test_epoch/test_avg_x2_acc", "x2_test_acc"),
    ("val_epoch/val_avg_acc", "val_acc_epoch"),
    ("val_epoch/val_avg_loss", "val_loss_epoch"),
    ("train_epoch/train_avg_acc", "train_acc_epoch"),
    ("train_epoch/train_avg_loss", "train_loss_epoch"),
]


def _rows_from_seeds_csv(path: str):
    """Per-seed rows out of the multiseed trainer's seeds.csv
    (``engine/multiseed.py::_write_seed_csv``)."""
    with open(path, newline="") as f:
        reader = list(csv.reader(f))
    header, body = reader[0], reader[1:]
    rows = []
    for row in body:
        if row[0] in ("mean", "std"):
            continue
        metrics = {}
        for key, value in zip(header[1:], row[1:]):
            try:
                metrics[key] = float(value)
            except ValueError:
                pass
        rows.append((f"seed-{row[0]}", metrics))
    return rows


def _rows_from_jsonl(path: str):
    """One row per run from RunLogger's epochs.jsonl: last val epoch merged
    with the test epoch (epoch == -1)."""
    merged = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            merged.update({k: v for k, v in rec.items()
                           if isinstance(v, (int, float))})
    name = os.path.basename(os.path.dirname(os.path.abspath(path)))
    return [(name, merged)]


def export(run_dirs, out_path: str) -> int:
    rows = []
    for run_dir in run_dirs:
        seeds_csv = os.path.join(run_dir, "seeds.csv")
        jsonl = os.path.join(run_dir, "metrics.jsonl")
        if os.path.exists(seeds_csv):
            rows.extend(_rows_from_seeds_csv(seeds_csv))
        elif os.path.exists(jsonl):
            rows.extend(_rows_from_jsonl(jsonl))
        else:
            print(f"[analyze] no seeds.csv/metrics.jsonl in {run_dir}; skipped")
    columns = ["Name"] + [dst for _, dst in COLUMN_MAP]
    with open(out_path, "w", newline="") as f:
        writer = csv.writer(f, quoting=csv.QUOTE_ALL)
        writer.writerow(columns)
        for name, metrics in rows:
            writer.writerow([name] + [metrics.get(src, "")
                                      for src, _ in COLUMN_MAP])
    print(f"[analyze] wrote {out_path} ({len(rows)} runs)")
    return len(rows)


def compare(jlogits_csv: str, ensemble_csv: str):
    """mimic/analyze_data.py:4-23 — paired counts of jlogits > ensemble."""

    def read(path):
        with open(path, newline="") as f:
            return list(csv.DictReader(f))

    jl, en = read(jlogits_csv), read(ensemble_csv)
    out = {}
    for column, label in (("test_acc_epoch", "logits_acc"),
                          ("x1_test_acc", "x1_acc"),
                          ("x2_test_acc", "x2_acc")):
        pairs = [(float(a[column]), float(b[column]))
                 for a, b in zip(jl, en) if a[column] and b[column]]
        count = sum(1 for a, b in pairs if a > b)
        out[column] = count
        print(f"Number of instances where {label} logits is greater than "
              f"ensemble: {count}")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_exp = sub.add_parser("export")
    p_exp.add_argument("--run-dir", nargs="+", required=True)
    p_exp.add_argument("--out", required=True)
    p_cmp = sub.add_parser("compare")
    p_cmp.add_argument("--jlogits", required=True)
    p_cmp.add_argument("--ensemble", required=True)
    args = parser.parse_args(argv)
    if args.cmd == "export":
        export(args.run_dir, args.out)
    else:
        compare(args.jlogits, args.ensemble)


if __name__ == "__main__":
    main()
