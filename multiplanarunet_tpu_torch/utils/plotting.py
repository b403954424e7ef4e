"""Plotting utilities: learning curves, sample panels, view spheres.

Port of `multiplanarunet_tpu/utils/plotting.py` (save_images sample
batches, prediction panels, learning-curve pngs from the training CSV,
the `plot_views` unit-sphere figure). matplotlib is imported (Agg) inside
each function, so this module imports without it; callers catch any
failure, a missing matplotlib included, log one warning and train on."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def pyplot():
    """matplotlib.pyplot on the headless Agg backend (ImportError without
    matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def require_matplotlib():
    """Raise ImportError when matplotlib cannot be imported."""
    pyplot()


def _host(a):
    """A numpy copy of a torch tensor (any device) or an array."""
    if hasattr(a, "detach"):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def plot_training_curves(csv_path, out_path, log_keys=("loss", "val_loss"),
                         dice_keys=("val_dice", "val_precision", "val_recall")):
    """Two-panel learning curve (losses / val scores) from training.csv."""
    import csv as _csv

    plt = pyplot()

    with open(csv_path) as f:
        rows = list(_csv.DictReader(f))
    if not rows:
        return
    epochs = [int(float(r["epoch"])) for r in rows]

    def series(key):
        out = []
        for r in rows:
            try:
                out.append(float(r[key]))
            except (KeyError, ValueError, TypeError):
                out.append(np.nan)
        return np.asarray(out)

    fig, axes = plt.subplots(2, 1, figsize=(8, 8), sharex=True)
    for key in log_keys:
        s = series(key)
        if np.isfinite(s).any():
            axes[0].plot(epochs, s, label=key)
    axes[0].set_ylabel("loss")
    axes[0].legend(loc="best")
    for key in dice_keys:
        s = series(key)
        if np.isfinite(s).any():
            axes[1].plot(epochs, s, label=key)
    axes[1].set_ylabel("score")
    axes[1].set_xlabel("epoch")
    axes[1].legend(loc="best")
    fig.tight_layout()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=100)
    plt.close(fig)


def _mid_slice_2d(arr):
    """Reduce an (H, W, C) / (D, H, W, C) array to a 2D grayscale image."""
    arr = np.asarray(arr)
    if arr.ndim == 4:  # 3D volume -> middle slice
        arr = arr[arr.shape[0] // 2]
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr


def save_prediction_panel(X, y, probs, out_path, max_images=4):
    """Rows of (input | truth | argmax prediction) for a batch sample."""
    plt = pyplot()
    X, y, probs = _host(X), _host(y), _host(probs)
    n = min(len(X), max_images)
    fig, axes = plt.subplots(n, 3, figsize=(9, 3 * n), squeeze=False)
    pred_cls = np.argmax(probs, axis=-1)
    y = np.asarray(y)
    if y.shape[-1] == 1:
        y = y[..., 0]
    if y.ndim == 2 and X.ndim >= 4:  # flattened labels
        side = int(np.sqrt(y.shape[1]))
        y = y.reshape(y.shape[0], side, side)
        pred_cls = pred_cls.reshape(pred_cls.shape[0], side, side)
    for i in range(n):
        axes[i][0].imshow(_mid_slice_2d(X[i]), cmap="gray")
        axes[i][0].set_title("input")
        axes[i][1].imshow(_mid_slice_2d(y[i][..., None]), vmin=0)
        axes[i][1].set_title("truth")
        axes[i][2].imshow(_mid_slice_2d(pred_cls[i][..., None]), vmin=0)
        axes[i][2].set_title("pred")
        for ax in axes[i]:
            ax.axis("off")
    fig.tight_layout()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=100)
    plt.close(fig)


def save_images(train_batch, val_batch, out_dir, logger=None):
    """Save sample input/label panels from train (and val) batches before
    training starts."""
    plt = pyplot()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, batch in (("train", train_batch), ("val", val_batch)):
        if batch is None:
            continue
        X, y, _ = batch
        X, y = _host(X), _host(y)
        n = min(len(X), 4)
        fig, axes = plt.subplots(n, 2, figsize=(6, 3 * n), squeeze=False)
        yy = y[..., 0] if y.shape[-1] == 1 else y
        if yy.ndim == 2 and X.ndim >= 4:
            side = int(np.sqrt(yy.shape[1]))
            yy = yy.reshape(yy.shape[0], side, side)
        for i in range(n):
            axes[i][0].imshow(_mid_slice_2d(X[i]), cmap="gray")
            axes[i][1].imshow(_mid_slice_2d(yy[i][..., None]), vmin=0)
            for ax in axes[i]:
                ax.axis("off")
        fig.tight_layout()
        fig.savefig(out_dir / f"{name}_images.png", dpi=100)
        plt.close(fig)


def plot_views(views, out_path):
    """3D unit-sphere figure of the sampled view vectors."""
    plt = pyplot()
    from mpl_toolkits.mplot3d import Axes3D  # noqa: F401

    views = np.asarray(views)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    u, v = np.mgrid[0:2 * np.pi:30j, 0:np.pi:20j]
    ax.plot_wireframe(np.cos(u) * np.sin(v), np.sin(u) * np.sin(v),
                      np.cos(v), color="lightgray", linewidth=0.3)
    for i, view in enumerate(views):
        ax.quiver(0, 0, 0, *view, length=1.0, arrow_length_ratio=0.1)
        ax.text(*(view * 1.15), f"v{i}", fontsize=9)
    ax.set_xlim(-1, 1)
    ax.set_ylim(-1, 1)
    ax.set_zlim(-1, 1)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
