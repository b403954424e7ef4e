"""Auditor: scans dataset headers and proposes sampling hyperparameters.

Port of `multiplanarunet_tpu/image/auditor.py`: reads every train and
val NIfTI header for shapes, voxel sizes, physical sizes and memory;
infers `n_classes` from up to 50 label volumes unless the hparams set it;
chooses the 2D sample dim (the 16-divisible dim in [min_dim, max_dim]
nearest real_space_span / sample_res, shrinking the span when that dim
would under-resolve it), real_space_span (75th percentile of the
physical axis sizes), and for the 3D model the box: sample_dim_3D =
dim_3d voxels spanning real_box_span = dim_3d * sample_res (the 25th
percentile voxel size); and `fill` writes the values of a model type
('2d', '3d', or 'multi_task_2d', whose 2D values go to a task YAML's
task_specifics group) into the YAML where the file has Null.
"""

from __future__ import annotations

import numpy as np

from multiplanarunet_tpu_torch.io import nifti
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.ops.geometry import (
    get_pix_dim,
    get_real_image_size,
)


def audit_n_classes(label_paths, logger=None, max_files=50, rng=None):
    """The class count: the union of label values over <= 50 random
    volumes, which must be 0..n-1."""
    logger = logger or ScreenLogger()
    logger("Auditing number of target classes (reads label data from disk; "
           "set n_classes in train_hparams.yaml to skip).")
    rng = rng or np.random
    paths = list(label_paths)
    if len(paths) > max_files:
        idx = rng.choice(len(paths), max_files, replace=False)
        paths = [paths[i] for i in idx]
    values = set()
    for p in paths:
        values.update(np.unique(nifti.load(p).get_raw_data()).tolist())
    classes = np.array(sorted(int(v) for v in values))
    if classes[0] != 0:
        raise ValueError(
            f"Class audit failed: classes must start at 0, found {classes}")
    if len(classes) != classes[-1] + 1:
        raise ValueError(f"Class audit failed: classes must be contiguous "
                         f"from 0, found {classes}")
    return int(len(classes))


class Auditor:
    """Header audit + sampling-hyperparameter heuristic for a NIfTI
    dataset."""

    def __init__(self, nii_paths, nii_lab_paths=None, logger=None,
                 min_dim_2d=128, max_dim_2d=512, dim_3d=64,
                 span_percentile=75, res_percentile=25, hparams=None):
        self.nii_paths = list(nii_paths)
        self.nii_lab_paths = list(nii_lab_paths) if nii_lab_paths else None
        self.logger = logger or ScreenLogger()
        self.hparams = hparams

        self.info = self.audit()
        channels = np.asarray(self.info["n_channels"])
        if not np.all(channels == channels[0]):
            raise ValueError(f"Images have differing channel counts: "
                             f"{sorted(set(channels))}")
        self.n_channels = int(channels[0])
        self.n_classes = self.info["n_classes"]

        real_space_span = float(np.percentile(self.info["real_sizes"],
                                              span_percentile))
        sample_res = float(np.percentile(self.info["pixdims"],
                                         res_percentile))
        self.sample_dim_2D, self.real_space_span_2D = \
            self.heuristic_sample_dim(real_space_span, sample_res,
                                      min_dim_2d, max_dim_2d)
        self.sample_dim_3D = int(dim_3d)
        self.real_space_span_3D = real_space_span
        self.real_box_span = dim_3d * sample_res
        self.total_memory_bytes = int(sum(self.info["memory_bytes"]))
        self.total_memory_gib = self.total_memory_bytes / 1024 ** 3
        # attribute -> ([group, ...], [key, ...]) destinations in the YAML
        self.patterns = {
            "2d": {
                "real_space_span_2D": (["fit"], ["real_space_span"]),
                "sample_dim_2D": (["build"], ["dim"]),
                "n_channels": (["build"], ["n_channels"]),
                "n_classes": (["build"], ["n_classes"]),
            },
            "3d": {
                "real_space_span_3D": (["fit"], ["real_space_span"]),
                "sample_dim_3D": (["build"], ["dim"]),
                "real_box_span": (["fit"], ["real_box_dim"]),
                "n_channels": (["build"], ["n_channels"]),
                "n_classes": (["build"], ["n_classes"]),
            },
            # a multi-task project audits each task's own YAML
            "multi_task_2d": {
                "real_space_span_2D": (["task_specifics"],
                                       ["real_space_span"]),
                "sample_dim_2D": (["task_specifics"], ["dim"]),
                "n_channels": (["task_specifics"], ["n_channels"]),
                "n_classes": (["task_specifics"], ["n_classes"]),
            },
        }
        self.log()

    def audit(self):
        shapes, channels, real_sizes, pixdims, memory = [], [], [], [], []
        for path in self.nii_paths:
            img = nifti.load(path)  # header only
            shape = img.shape
            shapes.append(shape[:3])
            channels.append(shape[3] if len(shape) > 3 else 1)
            real_sizes.append(get_real_image_size(img))
            pixdims.append(get_pix_dim(img))
            memory.append(img.get_data_dtype().itemsize * int(np.prod(shape)))
        n_classes = None
        if self.nii_lab_paths is not None:
            if self.hparams is not None:
                n_classes = self.hparams.get_from_anywhere("n_classes")
            if n_classes is None:
                n_classes = audit_n_classes(self.nii_lab_paths, self.logger)
        return {"shapes": shapes, "real_sizes": real_sizes,
                "pixdims": pixdims, "memory_bytes": memory,
                "n_channels": channels, "n_classes": n_classes}

    @staticmethod
    def heuristic_sample_dim(real_space_span, res, min_dim, max_dim):
        """The 16-divisible dim nearest span/res; when it under-resolves
        the span by > 10%, the span shrinks toward dim * res."""
        valid = np.array([d for d in range(min_dim, max_dim + 1)
                          if d % 16 == 0])
        ideal = real_space_span / res
        dim = int(valid[np.abs(valid - ideal).argmin()])
        if dim < ideal * 0.90:
            preferred = dim * res
            real_space_span = max(int(real_space_span * 0.70), preferred)
        return dim, real_space_span

    def log(self):
        self.logger(f"\nAudit for {len(self.nii_paths)} images")
        self.logger(f"Total memory GiB:  {self.total_memory_gib:.3f}")
        if self.n_classes is not None:
            self.logger(f"Number of classes: {self.n_classes}")
        self.logger(f"\n2D:\nReal space span:   {self.real_space_span_2D:.3f}"
                    f"\nSample dim:        {self.sample_dim_2D:.3f}")
        self.logger(f"\n3D:\nSample dim:        {self.sample_dim_3D}\n"
                    f"Real space span:   {self.real_space_span_3D:.3f}\n"
                    f"Box span:          {self.real_box_span:.3f}")

    def fill(self, hparams, model_type):
        """Write the audited values into hparams and its YAML file where
        they are not set (overwrite=False)."""
        pattern = self.patterns.get(model_type.lower())
        if pattern is None:
            raise ValueError(f"Unknown or unported model type: "
                             f"'{model_type}' (ported: "
                             f"{sorted(self.patterns)})")
        for attr, (groups, names) in pattern.items():
            value = getattr(self, attr)
            for group, name in zip(groups, names):
                hparams.set_value(subdir=group, name=name, value=value)
        hparams.save_current()
