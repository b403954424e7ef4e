"""`mp summary` on the PyTorch port: aggregate prediction result CSVs into
a dice report.

Port of `multiplanarunet_tpu/bin/summary.py` without pandas: walks result
folders for csv/ sub-directories (as `mp predict` writes them, through
`logging/log_results.py`) and reports the overall fused mean dice +/-
std, per-class means and per-view means, in the JAX package's text. The
statistics are pandas': a mean skips NaN, a std skips NaN and divides by
N - 1 (NaN for fewer than two values).

Run as ``python -m multiplanarunet_tpu_torch.bin.mp summary --dir
<predictions> [--out report.txt]``.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser
from glob import glob
from pathlib import Path

import numpy as np

from multiplanarunet_tpu_torch.logging.log_results import ResultTable


def get_argparser():
    parser = ArgumentParser(description="Summarize prediction results")
    parser.add_argument("--dir", type=str, default="./",
                        help="Folder (or glob pattern) of prediction result "
                             "directories containing a csv/ subfolder")
    parser.add_argument("--out", type=str, default=None,
                        help="Optional path to write the report text file")
    return parser


def find_result_dirs(pattern):
    hits = []
    for path in glob(pattern) or [pattern]:
        for root, dirs, files in os.walk(path):
            if os.path.basename(root) == "csv" and "results.csv" in files:
                hits.append(root)
    return sorted(set(hits))


def _dropna(values):
    values = np.asarray(values, np.float64)
    return values[~np.isnan(values)]


def _mean(values):
    """Mean of NaN-free values; NaN for none."""
    return values.sum() / len(values) if len(values) else np.nan


def _std(values):
    """ddof=1 standard deviation of NaN-free values; NaN for fewer than
    two."""
    if len(values) < 2:
        return np.nan
    return np.sqrt(((_mean(values) - values) ** 2).sum() / (len(values) - 1))


def parse_results(csv_dir):
    """(results table, {csv stem: per-class table}) of one csv folder,
    as ResultTables (the JAX package returns DataFrames); results.csv and
    detailed.csv are not per-class tables."""
    results = ResultTable.read_csv(os.path.join(csv_dir, "results.csv"))
    pc = {}
    for path in glob(os.path.join(csv_dir, "*.csv")):
        name = Path(path).stem
        if name in ("results", "detailed"):
            continue
        pc[name] = ResultTable.read_csv(path)
    return results, pc


def build_report(csv_dirs):
    lines = []
    all_mj = []
    for csv_dir in csv_dirs:
        results, pc = parse_results(csv_dir)
        lines.append(f"\n=== {csv_dir} ===")
        if "MJ" in results.columns:
            mj = _dropna(results.values[:, results.columns.index("MJ")])
            all_mj.append(mj)
            lines.append(f"Fused (MJ) mean dice: {_mean(mj):.3f} "
                         f"+/- {_std(mj):.3f}  (N={len(mj)})")
        if "MJ" in pc:
            per_class = pc["MJ"]
            lines.append("Per-class mean dice:")
            for cls, row in zip(per_class.index, per_class.values):
                lines.append(f"  class {cls}: {_mean(_dropna(row)):.3f}")
        view_cols = [j for j, c in enumerate(results.columns) if c != "MJ"]
        if view_cols:
            lines.append("Per-view mean dice:")
            for j in view_cols:
                col = _dropna(results.values[:, j])
                if len(col):
                    lines.append(f"  {results.columns[j]}: {_mean(col):.3f}")
    if all_mj:
        cat = np.concatenate(all_mj)
        lines.insert(0, f"Overall fused mean dice: {_mean(cat):.3f} "
                        f"+/- {_std(cat):.3f}  (N={len(cat)})")
    return "\n".join(lines)


def entry_func(args=None):
    args = get_argparser().parse_args(args)
    csv_dirs = find_result_dirs(args.dir)
    if not csv_dirs:
        print(f"No result csv folders found under '{args.dir}'")
        return
    report = build_report(csv_dirs)
    print(report)
    if args.out:
        Path(args.out).write_text(report + "\n")


if __name__ == "__main__":
    entry_func()
