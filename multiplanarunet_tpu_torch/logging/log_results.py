"""Per-image / per-view / per-class evaluation result tables of
`mp predict` and `mp predict_3D`, without pandas.

Port of `multiplanarunet_tpu/logging/log_results.py` with the same file
layout: <out_dir>/csv/results.csv (image x (views + fused "MJ") mean
dice), <out_dir>/csv/MJ.csv and one csv per view (class x image dice)
named by `_view_fname`, and their twins as text tables under txt/; for
`mp predict_3D`, results.csv (image x one unnamed mean-dice column "0")
and detailed.csv (class x image dice). The
CSVs are written as pandas writes them (index column first, floats at
full precision, NaN as an empty field), so the JAX package's `mp summary`
and `load_result_dicts` read the port's files and the port reads theirs.
"""

from __future__ import annotations

import csv
import os
import re
from glob import glob

import numpy as np

from multiplanarunet_tpu_torch.utils.utils import create_folders

_FLOAT_RE = re.compile(r"[-]?\d\.\d+")


class ResultTable:
    """A float table keyed by row and column labels, NaN where unset
    (the port's stand-in for the JAX package's pandas frames). Setting a
    missing row or column adds it. A column filled from a float32 array
    is written at float32 precision, as pandas writes a float32
    column."""

    def __init__(self, index_name, index, columns):
        self.index_name = index_name
        self.index = list(index)
        self.columns = list(columns)
        self.values = np.full((len(self.index), len(self.columns)), np.nan)
        self.f32_columns = set()

    def _row(self, label):
        if label not in self.index:
            self.index.append(label)
            self.values = np.vstack(
                [self.values, np.full((1, len(self.columns)), np.nan)])
        return self.index.index(label)

    def _col(self, label):
        if label not in self.columns:
            self.columns.append(label)
            self.values = np.hstack(
                [self.values, np.full((len(self.index), 1), np.nan)])
        return self.columns.index(label)

    def set(self, row, col, value):
        self.values[self._row(row), self._col(col)] = float(value)

    def set_column(self, col, values):
        """Fill column `col` top to bottom from `values`."""
        values = np.asarray(values)
        self.values[:, self._col(col)] = values.astype(np.float64)
        if values.dtype == np.float32:
            self.f32_columns.add(col)
        else:
            self.f32_columns.discard(col)

    def get(self, row, col):
        return float(self.values[self.index.index(row),
                                 self.columns.index(col)])

    # ------------------------------------------------------------ files
    def write_csv(self, path):
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow([self.index_name] + [str(c) for c in self.columns])
            kinds = [np.float32 if c in self.f32_columns else np.float64
                     for c in self.columns]
            for label, row in zip(self.index, self.values):
                w.writerow([label] + ["" if np.isnan(v) else str(kind(v))
                                      for v, kind in zip(row, kinds)])
            f.write("\n")

    @classmethod
    def read_csv(cls, path):
        with open(path, newline="") as f:
            rows = [r for r in csv.reader(f) if r]
        header, body = rows[0], rows[1:]
        as_int = header[0] == "class"
        table = cls(header[0], [int(r[0]) if as_int else r[0] for r in body],
                    header[1:])
        for i, r in enumerate(body):
            table.values[i] = [float(v) if v != "" else np.nan
                               for v in r[1:]]
        return table

    def to_text(self):
        cols = [str(c) for c in self.columns]
        cells = [["NaN" if np.isnan(v) else f"{v:.6f}" for v in row]
                 for row in self.values]
        labels = [str(i) for i in self.index]
        lw = max([len(self.index_name)] + [len(s) for s in labels])
        widths = [max([len(c)] + [len(r[j]) for r in cells])
                  for j, c in enumerate(cols)]
        lines = [" " * lw + "".join(f"  {c:>{w}}"
                                    for c, w in zip(cols, widths))]
        if self.index_name:
            lines.append(self.index_name)
        for label, row in zip(labels, cells):
            lines.append(f"{label:<{lw}}" + "".join(
                f"  {v:>{w}}" for v, w in zip(row, widths)))
        return "\n".join(lines)


def init_result_dicts(views, all_images, n_classes):
    """(results table indexed by image id, {view / "MJ": per-class
    table})."""
    if n_classes == 1:
        n_classes = 2
    keys = [str(v) for v in views] + ["MJ"]
    results = ResultTable("identifier", sorted(all_images), keys)
    pc_results = {k: ResultTable("class", range(1, n_classes), all_images)
                  for k in keys}
    return results, pc_results


def init_result_dict_3D(all_images, n_classes):
    """(results table: image x the mean dice column "0", detailed table:
    class x image dice), all NaN."""
    if n_classes == 1:
        n_classes = 2
    return (ResultTable("", all_images, ["0"]),
            ResultTable("class", range(1, n_classes), all_images))


def load_result_dicts(csv_dir, views):
    """Reload result tables from a previous run (`mp predict --continue`),
    matching each view to its csv by the view's float components."""
    csv_dir = os.path.abspath(csv_dir)
    results = ResultTable.read_csv(os.path.join(csv_dir, "results.csv"))
    pc_results = {"MJ": ResultTable.read_csv(os.path.join(csv_dir,
                                                          "MJ.csv"))}
    paths = glob(os.path.join(csv_dir, "*csv"))
    for v in views:
        v = np.asarray(v, np.float64)
        for path in paths:
            stem = os.path.splitext(os.path.basename(path))[0]
            comps = np.array(_FLOAT_RE.findall(stem), np.float64)
            if len(comps) == 3 and np.all(comps.round(4) == v.round(4)):
                pc_results[str(v)] = ResultTable.read_csv(path)
                break
        else:
            raise RuntimeError(
                f"Could not match view {v} to any csv in {csv_dir}")
    return results, pc_results


def _view_fname(view):
    return str(view).replace("[", "").strip().replace("]", "").replace(
        " ", "_")


def save_all(results, pc_results, out_dir):
    txt_dir = os.path.join(out_dir, "txt")
    csv_dir = os.path.join(out_dir, "csv")
    create_folders([txt_dir, csv_dir])
    tables = [("results", results)] + [(_view_fname(view), frame)
                                       for view, frame in pc_results.items()]
    for fname, table in tables:
        table.write_csv(os.path.join(csv_dir, f"{fname}.csv"))
        with open(os.path.join(txt_dir, f"{fname}.txt"), "w") as f:
            f.write(table.to_text() + "\n")


def save_all_3D(results, detailed, out_dir):
    """csv/ and txt/ results and detailed tables of `mp predict_3D`."""
    txt_dir = os.path.join(out_dir, "txt")
    csv_dir = os.path.join(out_dir, "csv")
    create_folders([txt_dir, csv_dir])
    for fname, table in (("results", results), ("detailed", detailed)):
        table.write_csv(os.path.join(csv_dir, f"{fname}.csv"))
        with open(os.path.join(txt_dir, f"{fname}.txt"), "w") as f:
            f.write(table.to_text() + "\n")
