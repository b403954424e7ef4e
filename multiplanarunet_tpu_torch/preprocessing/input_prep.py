"""Input shaping helpers (port of
`multiplanarunet_tpu/preprocessing/input_prep.py`, numpy)."""

from __future__ import annotations

import numpy as np


def reshape_add_axis(X, im_dims=2):
    """Ensure a leading batch axis and trailing channel axis for an image of
    `im_dims` spatial dimensions."""
    X = np.asarray(X)
    if X.ndim == im_dims:  # no channel, no batch
        X = X[None, ..., None]
    elif X.ndim == im_dims + 1:  # channel, no batch
        X = X[None]
    return X


def one_hot_encode_y(y, n_classes):
    """Integer labels -> one-hot float32 (legacy dense-target support)."""
    y = np.asarray(y).astype(np.int64)
    return np.eye(n_classes, dtype=np.float32)[y]
