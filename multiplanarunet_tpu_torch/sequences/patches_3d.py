"""Voxel-space 3D patch samplers (patches_3d / sliding_patches_3d).

Port of `multiplanarunet_tpu/sequences/patches_3d.py`: random fg-aware
patches cut from the image's voxel grid (center_expand padding of patches
that leave it), and their base and random prediction generators; the
sliding variant draws its corners from a strided lattice. The sampling
is host numpy with the JAX package's np.random draws in its order, so a
seed gives the same corners and the same arrays. A training batch is
(X (B, d, d, d, C) float32, y (B, d, d, d, 1) in the labels' dtype) as
tensors on the sequence's device, and w (B,) float32 numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from multiplanarunet_tpu_torch._device import resolve_device
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.sequences.base_sequence import BaseSequence


def center_expand(im, target_dim, bg_value, random=True):
    """Pad a volume below `target_dim` to target_dim^3 (a random placement
    when random, else centered)."""
    shape = (target_dim,) * 3 + ((im.shape[-1],) if im.ndim == 4 else ())
    cim = np.full(shape, bg_value, dtype=im.dtype)
    diff = np.asarray(cim.shape[:3]) - im.shape[:3]
    if random and np.any(diff):
        start = [np.random.randint(0, max(d, 1)) for d in diff]
    else:
        start = diff // 2
    cim[start[0]:start[0] + im.shape[0],
        start[1]:start[1] + im.shape[1],
        start[2]:start[2] + im.shape[2]] = im
    return cim


class PatchSequence3D(BaseSequence):
    """Random voxel-space patches with a foreground quota."""

    def __init__(self, image_pair_queue, dim, n_classes, batch_size,
                 is_validation=False, label_crop=None, fg_batch_fraction=0.33,
                 logger=None, bg_val=0.0, no_log=False, device=None,
                 **kwargs):
        super().__init__()
        self.logger = logger or ScreenLogger()
        self.image_pair_queue = image_pair_queue
        self.dim = int(dim)
        self.n_classes = int(n_classes)
        self.label_crop = label_crop
        self.is_validation = is_validation
        self.batch_size = batch_size
        self.bg_value = bg_val
        self.fg_batch_fraction = fg_batch_fraction
        self.fg_classes = np.arange(1, self.n_classes)
        if self.fg_classes.shape[0] == 0:
            self.fg_classes = np.array([1])
        self.device = resolve_device(device)
        if not is_validation and not no_log:
            self.log()

    def log(self):
        self.logger(f"\nPatchSequence3D: dim={self.dim}, "
                    f"batch={self.batch_size}, fg_frac={self.fg_batch_fraction}")

    @property
    def n_fg_slices(self):
        if self.is_validation:
            return self.batch_size
        return int(np.ceil(self.batch_size * self.fg_batch_fraction))

    # ------------------------------------------------------------- sampling
    def _random_corner(self, vol_shape):
        return [np.random.randint(0, max(s - self.dim, 1))
                for s in vol_shape[:3]]

    def _cut(self, arr, corner):
        out = arr[tuple(slice(c, c + self.dim) for c in corner)]
        if np.any(np.asarray(out.shape[:3]) < self.dim):
            out = center_expand(out, self.dim, self.bg_value, random=False)
        return out

    def _sample_patch(self, image, need_fg):
        """Draw a patch; when need_fg, retry up to 10 times for
        foreground."""
        vol, lab_vol = image.image, image.labels
        for tries in range(10):
            corner = self._random_corner(vol.shape)
            lab = self._cut(lab_vol, corner)
            has_fg = bool(np.isin(self.fg_classes, lab).any())
            if has_fg or not need_fg or tries == 9:
                im = image.scaler.transform(self._cut(vol, corner))
                return im, lab, has_fg

    def __getitem__(self, idx):
        self.seed()
        xs, ys, ws = [], [], []
        fg_count = 0
        for _ in range(self.batch_size):
            with self.image_pair_queue.get_random_image() as image:
                slots_left = self.batch_size - len(xs)
                need_fg = (self.n_fg_slices - fg_count) >= slots_left
                im, lab, has_fg = self._sample_patch(image, need_fg)
                fg_count += int(has_fg)
                xs.append(im)
                ys.append(lab)
                ws.append(image.sample_weight)
        X = torch.from_numpy(np.stack(xs).astype(np.float32))
        y = torch.from_numpy(np.stack(ys)[..., None])
        return (X.to(self.device), y.to(self.device),
                np.asarray(ws, np.float32))

    # ------------------------------------------------------------ inference
    def base_corners(self, image):
        """(N, 3) int corners of the base tiling (shared by the host patch
        generator and the device recon of predict_3D_patches)."""
        sample_space = np.maximum(np.asarray(image.shape[:3]), self.dim)
        d = sample_space - self.dim
        n = np.ceil(sample_space / self.dim).astype(int)
        axes = [np.linspace(0, d[i], n[i]).astype(int) for i in range(3)]
        mesh = np.meshgrid(*axes, indexing="ij")
        return np.stack([m.ravel() for m in mesh], axis=1)

    def get_base_patches(self, image):
        X = image.image
        for p in self.base_corners(image):
            patch = self._cut(X, p)
            yield image.scaler.transform(patch), tuple(int(v) for v in p)

    def get_N_random_patches_from(self, image, N):
        X = image.image
        for _ in range(int(N)):
            corner = self._random_corner(X.shape)
            patch = self._cut(X, corner)
            yield image.scaler.transform(patch), tuple(corner)

    def get_patches_from(self, image, n_extra=0):
        """Yield (patch, corner, status_line) over base + extra patches."""
        for num, (p, coords) in enumerate(self.get_base_patches(image)):
            yield p, coords, f"   Predicting on base patches ({num + 1})"
        for num, (p, coords) in enumerate(
                self.get_N_random_patches_from(image, n_extra)):
            yield p, coords, f"   Predicting on extra patches ({num + 1})"


class SlidingPatchSequence3D(PatchSequence3D):
    """Deterministic strided patch corners for training and inference:
    corners advance by `strides` along each axis (dim // 2 by default);
    random corner draws pick uniformly from the strided lattice."""

    def __init__(self, image_pair_queue, dim, n_classes, batch_size,
                 strides=None, **kwargs):
        super().__init__(image_pair_queue, dim, n_classes, batch_size,
                         **kwargs)
        self.strides = int(strides) if strides else max(1, self.dim // 2)

    def corners_for(self, vol_shape):
        axes = [np.arange(0, max(s - self.dim, 0) + 1, self.strides)
                for s in vol_shape[:3]]
        mesh = np.meshgrid(*axes, indexing="ij")
        return np.stack([m.ravel() for m in mesh], axis=1)

    def _random_corner(self, vol_shape):
        corners = self.corners_for(vol_shape)
        return list(corners[np.random.randint(len(corners))])

    def base_corners(self, image):
        return self.corners_for(image.image.shape)
