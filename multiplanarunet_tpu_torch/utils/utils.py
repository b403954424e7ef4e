"""Host utilities (port of `multiplanarunet_tpu/utils/utils.py`):
checkpoint selection, resume helpers over logs/training.csv,
class-frequency estimates and the output-bias init, folders, PID
waiting, `highlighted`, `pred_to_class` and `random_split`."""

from __future__ import annotations

import csv
import os
import re
import time
from pathlib import Path

import numpy as np
import torch


def ensure_list_or_tuple(obj):
    return obj if isinstance(obj, (list, tuple)) else [obj]


def highlighted(string):
    length = max(len(s) for s in str(string).split("\n"))
    border = "-" * length
    return f"{border}\n{string}\n{border}"


def create_folders(folders, create_deep=False):
    maker = os.makedirs if create_deep else os.mkdir
    for f in ensure_list_or_tuple(folders):
        if f is not None and not os.path.exists(f):
            maker(f)


_EPOCH_RE = re.compile(r"@epoch_(\d+)")
_VAL_DICE_RE = re.compile(r"val_dice_([\d.]+)\.")
_VAL_LOSS_RE = re.compile(r"val_loss_([\d.]+)\.")


def get_best_model(model_dir):
    """The best checkpoint file of a model folder, by pattern priority:
    val_dice (max) > val_loss (min) > any '@epoch' file (max epoch) >
    the last .npz by name."""
    model_dir = Path(model_dir)
    files = sorted(str(p) for p in model_dir.glob("*.npz"))
    if not files:
        raise OSError(f"No model files found in {model_dir}")
    dice_files = [(float(m.group(1)), f) for f in files
                  for m in [_VAL_DICE_RE.search(os.path.basename(f))] if m]
    if dice_files:
        return max(dice_files)[1]
    loss_files = [(float(m.group(1)), f) for f in files
                  for m in [_VAL_LOSS_RE.search(os.path.basename(f))] if m]
    if loss_files:
        return min(loss_files)[1]
    epoch_files = [(int(m.group(1)), f) for f in files
                   for m in [_EPOCH_RE.search(os.path.basename(f))] if m]
    if epoch_files:
        return max(epoch_files)[1]
    return files[-1]


def get_last_model(model_dir):
    """(path, epoch) of the checkpoint with the highest '@epoch_NN' number;
    model_weights.npz with epoch 0 when there is none; (None, 0) when
    neither exists."""
    model_dir = Path(model_dir)
    epoch_files = []
    for f in sorted(model_dir.glob("*.npz")):
        m = _EPOCH_RE.search(f.name)
        if m:
            epoch_files.append((int(m.group(1)), str(f)))
    if not epoch_files:
        generic = model_dir / "model_weights.npz"
        if generic.exists():
            return str(generic), 0
        return None, 0
    epoch, path = max(epoch_files)
    return path, epoch


def get_lr_at_epoch(epoch, log_dir):
    """(learning rate, column name) recorded at `epoch` in
    <log_dir>/training.csv (the last row's when that epoch has no row);
    (None, None) without a file, rows or an lr column."""
    log_path = Path(log_dir) / "training.csv"
    if not log_path.exists():
        return None, None
    with open(log_path) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return None, None
    lr_col = next((c for c in rows[0] if c in ("lr", "learning_rate")), None)
    if lr_col is None:
        return None, None
    for row in rows:
        if int(float(row.get("epoch", -1))) == int(epoch):
            return float(row[lr_col]), lr_col
    return float(rows[-1][lr_col]), lr_col


def clear_csv_after_epoch(epoch, csv_path):
    """Drop the training.csv rows past `epoch` (resume semantics)."""
    csv_path = Path(csv_path)
    if not csv_path.exists():
        return
    lines = csv_path.read_text().splitlines()
    if not lines:
        return
    header, rows = lines[0], lines[1:]
    kept = [r for r in rows if r and int(float(r.split(",")[0])) <= epoch]
    csv_path.write_text("\n".join([header] + kept) + "\n")


def get_last_epoch(csv_path):
    """The epoch of the last row of a training.csv (0 without a file or
    rows)."""
    csv_path = Path(csv_path)
    if not csv_path.exists():
        return 0
    lines = [l for l in csv_path.read_text().splitlines()[1:] if l.strip()]
    if not lines:
        return 0
    return int(float(lines[-1].split(",")[0]))


def pred_to_class(tensor, img_dims=3, has_batch_dim=False, threshold=0.5):
    """Probability tensor -> integer class map (argmax / threshold); an
    array without a class axis is returned as it is."""
    tensor = np.asarray(tensor)
    if tensor.ndim == img_dims + int(has_batch_dim):
        return tensor
    if tensor.shape[-1] == 1:
        return (tensor[..., 0] >= threshold).astype(np.uint8)
    return np.argmax(tensor, axis=-1).astype(np.uint8)


def random_split(N, fractions, rng=None):
    """A permutation of range(N) split at the cumulative `fractions`
    (numpy's global stream unless `rng` is given)."""
    rng = rng or np.random
    idx = rng.permutation(N)
    splits = (np.cumsum(fractions)[:-1] * N).astype(int)
    return np.split(idx, splits)


def estimate_class_frequencies(image_queue, n_classes, max_images=25,
                               logger=None):
    """Label counts per class over (up to) `max_images` images of a
    queue; an image not loaded (a LimitationQueue's) is loaded for the
    count and unloaded after it."""
    counts = np.zeros(n_classes, np.int64)
    n = 0
    for image in image_queue.get_image_iterator(max_load=max_images):
        if image.is_loaded:
            counts += np.bincount(image.labels.ravel(), minlength=n_classes)
        else:
            with image.loaded_in_context():
                counts += np.bincount(image.labels.ravel(),
                                      minlength=n_classes)
        n += 1
    if logger:
        logger(f"Estimated class counts over {n} images: {counts}")
    return counts


def compute_class_weights(class_counts):
    """Inverse-frequency class weights normalised to mean 1 (the
    'class_weights: True' auto-fill)."""
    counts = np.asarray(class_counts, np.float64)
    freqs = counts / counts.sum()
    weights = 1.0 / np.maximum(freqs, 1e-8)
    return weights / weights.mean()


def set_bias_weights(model, class_counts, logger=None):
    """Set the out conv's bias to the log class frequencies, so the
    softmax starts at the empirical class prior (`biased_output_layer`)."""
    freqs = np.asarray(class_counts, np.float64)
    freqs = freqs / freqs.sum()
    bias = np.log(np.maximum(freqs, 1e-12)).astype(np.float32)
    if tuple(model.out_conv.bias.shape) != bias.shape:
        raise ValueError(f"Bias shape mismatch: "
                         f"{tuple(model.out_conv.bias.shape)} vs "
                         f"{bias.shape}")
    with torch.no_grad():
        model.out_conv.bias.copy_(torch.from_numpy(bias))
    if logger:
        logger(f"Setting out_conv bias to log class priors: {bias}")
    return model


def await_PIDs(pids, check_every=120, logger=None):
    """Block until the given PIDs (a list, or a comma-separated string) no
    longer exist."""
    if isinstance(pids, str):
        pids = [int(p) for p in pids.split(",")]
    pids = [int(p) for p in ensure_list_or_tuple(pids)]
    log = logger or print
    while pids:
        alive = []
        for pid in pids:
            try:
                os.kill(pid, 0)
            except OSError:
                continue
            alive.append(pid)
        if not alive:
            return
        log(f"Waiting for PIDs {alive} to terminate...")
        pids = alive
        time.sleep(check_every)
