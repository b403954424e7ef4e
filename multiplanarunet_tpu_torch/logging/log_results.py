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
and `load_result_dicts` read the port's files and the port reads theirs;
the text tables are pandas' `to_string()` of the same frames.
`to_df`, `results_to_csv` and `results_to_txt` take a ResultTable or the
JAX package's dict of columns.
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

    def update(self, other):
        """Take `other`'s non-NaN entries where its row and column labels
        are this table's (pandas DataFrame.update); labels this table
        lacks are ignored."""
        for i, row in enumerate(other.index):
            if row not in self.index:
                continue
            r = self.index.index(row)
            for j, col in enumerate(other.columns):
                v = other.values[i, j]
                if col in self.columns and not np.isnan(v):
                    self.values[r, self.columns.index(col)] = v

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

    def transposed(self):
        """The table with rows and columns swapped (no index name)."""
        table = ResultTable("", self.columns, self.index)
        table.values = self.values.T.copy()
        return table

    def to_text(self):
        """The table as pandas' DataFrame.to_string() writes a float
        frame: each column's values formatted as `_float_column` does,
        numeric headers with a leading space, columns right-aligned one
        space apart, index labels left-aligned, and the index name on a
        line of its own padded to the full width."""
        cols = [" " + str(c) for c in self.columns]
        cells = [_float_column(self.values[:, j])
                 for j in range(len(self.columns))]
        labels = [str(i) for i in self.index]
        lw = max([len(self.index_name)] + [len(s) for s in labels])
        widths = [max([len(c)] + [len(v) for v in col])
                  for c, col in zip(cols, cells)]
        lines = [" " * lw + "".join(f" {c:>{w}}"
                                    for c, w in zip(cols, widths))]
        if self.index_name:
            lines.append(self.index_name.ljust(len(lines[0])))
        for i, label in enumerate(labels):
            lines.append(f"{label:<{lw}}" + "".join(
                f" {col[i]:>{w}}" for col, w in zip(cells, widths)))
        return "\n".join(lines)


def _trim_zeros(strs):
    """pandas' trailing-zero trim: drop a last "0" from every fixed-point
    string while all of them end in one, keeping one decimal digit."""
    fixed = re.compile(r"^\s*[\+-]?[0-9]+\.[0-9]*$")
    nums = [i for i, x in enumerate(strs) if fixed.match(x)]
    while nums and all(strs[i].endswith("0") for i in nums):
        for i in nums:
            strs[i] = strs[i][:-1]
    for i in nums:
        if strs[i].endswith("."):
            strs[i] += "0"
    return strs


def _float_column(values, digits=6):
    """pandas' fixed-width strings of a float column: " .6f" with
    trailing zeros trimmed alike, or " .6e" when a nonzero value is below
    1e-6 or a value above 1e6 makes a string longer than 12; NaN as
    "NaN"."""
    def fmt(spec):
        return _trim_zeros(["NaN" if np.isnan(v) else format(v, spec)
                            for v in values])

    out = fmt(f" .{digits}f")
    a = np.abs(values[~np.isnan(values)])
    too_long = max((len(x) for x in out), default=0) > digits + 6
    if ((a < 10.0 ** -digits) & (a > 0)).any() or (too_long
                                                   and (a > 1e6).any()):
        out = fmt(f" .{digits}e")
    return out


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


def to_df(results, transpose=False):
    """A ResultTable of `results`: a ResultTable, or a dict of columns as
    the JAX package's tables are built (indexed by its "class" column
    when it has one, else by row number); transposed if asked. The port's
    stand-in for the JAX package's DataFrame."""
    if isinstance(results, ResultTable):
        table = results
    else:
        cols = {k: list(v) for k, v in results.items()}
        index = cols.pop("class", None)
        name = "" if index is None else "class"
        if index is None:
            index = range(len(next(iter(cols.values()), [])))
        table = ResultTable(name, index, cols)
        for j, col in enumerate(cols.values()):
            table.values[:, j] = np.asarray(col, np.float64)
    return table.transposed() if transpose else table


def results_to_csv(results, res_path, fname="results", transpose=False):
    """<res_path>/<fname>.csv as pandas writes the table, and a blank
    line."""
    to_df(results, transpose).write_csv(os.path.join(res_path,
                                                     f"{fname}.csv"))


def results_to_txt(results, res_path, fname="results", transpose=False):
    """<res_path>/<fname>.txt: the table as pandas' to_string() writes
    it, and a newline."""
    with open(os.path.join(res_path, f"{fname}.txt"), "w") as f:
        f.write(to_df(results, transpose).to_text() + "\n")


def save_all(results, pc_results, out_dir):
    txt_dir = os.path.join(out_dir, "txt")
    csv_dir = os.path.join(out_dir, "csv")
    create_folders([txt_dir, csv_dir])
    results_to_txt(results, txt_dir)
    results_to_csv(results, csv_dir)
    for view, frame in pc_results.items():
        results_to_txt(frame, txt_dir, fname=_view_fname(view))
        results_to_csv(frame, csv_dir, fname=_view_fname(view))


def save_all_3D(results, detailed, out_dir):
    """csv/ and txt/ results and detailed tables of `mp predict_3D`."""
    txt_dir = os.path.join(out_dir, "txt")
    csv_dir = os.path.join(out_dir, "csv")
    create_folders([txt_dir, csv_dir])
    for fname, table in (("results", results), ("detailed", detailed)):
        results_to_txt(table, txt_dir, fname=fname)
        results_to_csv(table, csv_dir, fname=fname)
