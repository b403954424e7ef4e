"""Data assembly for FusionModel training, on the host.

Port of `multiplanarunet_tpu/utils/fusion/fusion_training.py`: per image,
run every view through predict + remap, then stack the per-voxel
(n_views, n_classes) probability points with their integer targets.
`mp train_fusion` itself keeps its points on the device
(`MultiViewPredictor.predict_views_points`)."""

from __future__ import annotations

import numpy as np


def predict_and_map(predictor, image, views, n_planes="same+20"):
    """(points (n_vox, V, C), targets (n_vox,)) for one labelled image."""
    mapped = predictor.predict_views_mapped(image, views, n_planes=n_planes)
    V = mapped.shape[0]
    C = mapped.shape[-1]
    points = np.moveaxis(mapped.reshape(V, -1, C), 0, 1)  # (n_vox, V, C)
    targets = np.asarray(image.labels).reshape(-1)
    return points, targets


def stack_collections(points_collection, targets_collection):
    """Concatenate per-image point/target collections into flat arrays."""
    X = np.concatenate(points_collection, axis=0)
    y = np.concatenate(targets_collection, axis=0)
    return X, y
