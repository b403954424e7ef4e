"""Evaluation metrics: numpy for offline evaluation, torch for training.

Port of `multiplanarunet_tpu/evaluate/metrics.py`: `dice`, `dice_all`
over class maps and `dice_from_counts` over the (3, C) confusion counts
the predictor takes on the device; `precision_recall_dice`, the
Validation callback's epoch statistics from (tp, rel, sel) counts; and
the in-step training metrics `METRICS` over integer targets and class
probabilities (classes on the last axis), computed on the tensors'
device without a host sync; `class_wise_kappa` (Cohen's kappa per class,
as sklearn's cohen_kappa_score computes it on the class masks) and
`pred_to_class`.
"""

from __future__ import annotations

import numpy as np
import torch


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


def _binary_kappa(s1, s2):
    """sklearn.metrics.cohen_kappa_score of two boolean masks (NaN where
    sklearn's is undefined: one label in common)."""
    n = s1.size
    tp = float(np.sum(s1 & s2))
    fp = float(np.sum(~s1 & s2))
    fn = float(np.sum(s1 & ~s2))
    tn = n - tp - fp - fn
    if (tp + fn == n and tp + fp == n) or (tn + fp == n and tn + fn == n):
        return np.nan  # a single label: a 1x1 confusion matrix
    rows = (tn + fp, fn + tp)  # y1 == False, True
    cols = (tn + fn, fp + tp)  # y2 == False, True
    expected = (cols[0] * rows[1] + cols[1] * rows[0]) / n
    if expected == 0:
        return np.nan
    return float(1 - (fp + fn) / expected)


def class_wise_kappa(true, pred, n_classes=None, ignore_zero=True):
    """Cohen's kappa of each class's mask; NaN for classes absent from
    both."""
    if n_classes is None:
        classes = np.unique(true)
    else:
        classes = np.arange(max(2, n_classes))
    if ignore_zero:
        classes = classes[classes != 0]
    out = np.full(classes.shape, np.nan, np.float32)
    t = np.asarray(true).ravel()
    p = np.asarray(pred).ravel()
    for i, c in enumerate(classes):
        s1 = t == c
        s2 = p == c
        if s1.any() or s2.any():
            out[i] = _binary_kappa(s1, s2)
    return out


def pred_to_class(pred, img_dims=None, threshold=0.5, has_batch_dim=False):
    """Probability map -> integer class map (argmax; threshold if
    binary)."""
    pred = np.asarray(pred)
    if pred.shape[-1] == 1:
        return (pred[..., 0] >= threshold).astype(np.uint8)
    return np.argmax(pred, axis=-1).astype(np.uint8)


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


def precision_recall_dice(tp, rel, sel, ignore_bg=True):
    """Epoch-level per-class precision, recall and dice from confusion
    counts, and their means over the classes present in the labels:
    ((precision, recall, dice), (mean_p, mean_r, mean_d))."""
    tp = np.asarray(tp, np.float64)
    rel = np.asarray(rel, np.float64)
    sel = np.asarray(sel, np.float64)
    precision = np.where(sel > 0, tp / np.maximum(sel, 1), 0.0)
    recall = np.where(rel > 0, tp / np.maximum(rel, 1), 0.0)
    dice = np.where(rel + sel > 0, 2 * tp / np.maximum(rel + sel, 1), 0.0)
    if ignore_bg:
        precision, recall, dice = precision[1:], recall[1:], dice[1:]
        rel = rel[1:]
    mask = rel > 0
    if mask.any():
        means = (precision[mask].mean(), recall[mask].mean(),
                 dice[mask].mean())
    else:
        means = (0.0, 0.0, 0.0)
    return (precision, recall, dice), means


# ------------------------------------------------------- torch (training)
def _squeeze_target(y_true, y_pred):
    if y_true.shape[-1] == 1 and y_true.dim() == y_pred.dim():
        return y_true[..., 0]
    return y_true


def one_class_dice(y_true, y_pred, smooth=1.0, threshold=0.5):
    """Dice of a single-output (binary) model's thresholded prediction."""
    pred = (y_pred > threshold).float()
    y_true = y_true.float()
    return (smooth + 2.0 * torch.sum(y_true * pred)) / (
        smooth + torch.sum(y_true) + torch.sum(pred))


def confusion_matrix(y_true, y_pred_cls, n_classes):
    """(n_classes, n_classes) float32 counts, rows true, columns
    predicted; labels outside [0, n_classes) count nowhere."""
    t = y_true.reshape(-1).long()
    p = y_pred_cls.reshape(-1).long()
    ok = (t >= 0) & (t < n_classes) & (p >= 0) & (p < n_classes)
    idx = torch.where(ok, t * n_classes + p, n_classes * n_classes)
    counts = torch.bincount(idx, minlength=n_classes * n_classes + 1)
    return counts[:-1].reshape(n_classes, n_classes).float()


def sparse_categorical_accuracy(y_true, y_pred):
    y_true = _squeeze_target(y_true, y_pred)
    pred_cls = torch.argmax(y_pred, dim=-1)
    return torch.mean((pred_cls == y_true.long()).float())


def sparse_fg_recall(y_true, y_pred, bg_class=0):
    """Share of true-foreground pixels predicted with the right class."""
    y_true = _squeeze_target(y_true, y_pred).long()
    pred_cls = torch.argmax(y_pred, dim=-1)
    fg = (y_true != bg_class).float()
    correct = (pred_cls == y_true).float()
    return torch.sum(correct * fg) / torch.clamp(torch.sum(fg), min=1.0)


def sparse_fg_precision(y_true, y_pred, bg_class=0):
    """Share of predicted-foreground pixels whose class is right."""
    y_true = _squeeze_target(y_true, y_pred).long()
    pred_cls = torch.argmax(y_pred, dim=-1)
    fg = (pred_cls != bg_class).float()
    correct = (pred_cls == y_true).float()
    return torch.sum(correct * fg) / torch.clamp(torch.sum(fg), min=1.0)


def _cm_precisions_recalls(y_true, y_pred):
    n_classes = y_pred.shape[-1]
    y_true = _squeeze_target(y_true, y_pred)
    cm = confusion_matrix(y_true, torch.argmax(y_pred, dim=-1), n_classes)
    tp = torch.diagonal(cm)
    precisions = tp / torch.clamp(cm.sum(dim=0), min=1e-8)
    recalls = tp / torch.clamp(cm.sum(dim=1), min=1e-8)
    return precisions, recalls


def sparse_mean_fg_precision(y_true, y_pred):
    precisions, _ = _cm_precisions_recalls(y_true, y_pred)
    return torch.mean(precisions[1:])


def sparse_mean_fg_recall(y_true, y_pred):
    _, recalls = _cm_precisions_recalls(y_true, y_pred)
    return torch.mean(recalls[1:])


def sparse_mean_fg_f1(y_true, y_pred):
    precisions, recalls = _cm_precisions_recalls(y_true, y_pred)
    f1 = (2.0 * precisions * recalls) / torch.clamp(precisions + recalls,
                                                    min=1e-8)
    return torch.mean(f1[1:])


METRICS = {
    "one_class_dice": one_class_dice,
    "sparse_categorical_accuracy": sparse_categorical_accuracy,
    "sparse_fg_recall": sparse_fg_recall,
    "sparse_fg_precision": sparse_fg_precision,
    "sparse_mean_fg_precision": sparse_mean_fg_precision,
    "sparse_mean_fg_recall": sparse_mean_fg_recall,
    "sparse_mean_fg_f1": sparse_mean_fg_f1,
}
