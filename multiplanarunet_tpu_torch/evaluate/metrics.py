"""Evaluation metrics of `mp predict`, in numpy.

Port of the numpy half of `multiplanarunet_tpu/evaluate/metrics.py`:
`dice`, `dice_all` over class maps and `dice_from_counts` over the
(3, C) confusion counts the predictor takes on the device.
"""

from __future__ import annotations

import numpy as np


def dice(y_true, y_pred, smooth=1.0):
    """Soerensen dice between two binary masks."""
    s1 = np.asarray(y_true).ravel().astype(bool)
    s2 = np.asarray(y_pred).ravel().astype(bool)
    return (smooth + 2.0 * np.logical_and(s1, s2).sum()) / (
        smooth + s1.sum() + s2.sum())


def dice_all(y_true, y_pred, smooth=1.0, n_classes=None, ignore_zero=True,
             skip_if_no_y=False):
    """Per-class dice; NaN for classes absent from both masks."""
    if n_classes is None:
        classes = np.unique(y_true)
    else:
        classes = np.arange(max(2, n_classes))
    if ignore_zero:
        classes = classes[classes != 0]
    out = np.full(classes.shape, np.nan, np.float32)
    for i, c in enumerate(classes):
        s1 = np.asarray(y_true) == c
        if skip_if_no_y and not s1.any():
            continue
        s2 = np.asarray(y_pred) == c
        if s1.any() or s2.any():
            out[i] = dice(s1, s2, smooth=smooth)
    return out


def dice_from_counts(counts, smooth=1.0, ignore_zero=True):
    """Per-class dice from a (3, C) confusion-count matrix (tp,
    rel = |y == c|, sel = |pred == c|): the formula and NaN semantics of
    `dice_all` on the full masks (classes absent from both -> NaN)."""
    tp, rel, sel = np.asarray(counts, np.float64)
    out = np.full(tp.shape, np.nan, np.float32)
    present = (rel + sel) > 0
    out[present] = (smooth + 2.0 * tp[present]) / (
        smooth + rel[present] + sel[present])
    if ignore_zero:
        out = out[1:]
    return out
