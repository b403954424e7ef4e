"""Isotropic scanner-space 3D box sampler (iso_live_3d), sampled on a
device.

Port of `multiplanarunet_tpu/sequences/iso_3d.py:
IsotrophicLiveViewSequence3D`: training batches of randomly placed
(optionally slightly rotated) isotropic boxes of real_box_dim, sampled at
dim^3 voxels, with the same fg-quota rules as the 2D sampler, and the
inference generators (the base tiling of the image's scanner space, N
random boxes).

Each batch element is a random image of the queue and MAX_TRIES = 10
candidate (corner, rotation) pairs drawn on the host with numpy: per
element, the queue draw, then the 10 placements, then the 10 rotations
(the JAX package's order, so the n-th batch of a seed is the JAX
package's). The two paths are those of the 2D sampler
(`multi_planar.IsotrophicLiveViewSequence`):

- pooled (the default): the queue's images in a `DeviceVolumePool`; the
  B depth-0 candidate label boxes nearest-gathered in one call and
  reduced to class presence on the device; at the finish one fetch of
  that presence, one gather and fetch of the deeper candidates of the
  rows the rules may reject, the host walk, one linear gather of the B
  chosen boxes (`ops.interp.sample_box_batch_pool`): two host
  synchronisations per batch;
- per image (`use_pool = False`, a pool below the batch, or a dataset
  without labels): per element the 10 candidate label boxes and their
  presence, then the chosen box.

The path is chosen once, before the first batch; no exception switches
it. Batches are sampled one ahead by `base_sequence.prefetched`, with no
lookahead inside the sequence. Then Elastic3D, if configured, on the
device. Batches are (X (B, d, d, d, C) float32, y (B, d, d, d, 1), w (B,)
float32 numpy); y is int32, or float32 after an augmenter.
"""

from __future__ import annotations

import numpy as np
import torch

from multiplanarunet_tpu_torch.ops import geometry
from multiplanarunet_tpu_torch.ops.interp import (
    sample_box,
    sample_box_batch,
    sample_box_batch_pool,
)
from multiplanarunet_tpu_torch.sequences.multi_planar import (
    MAX_TRIES,
    IsotrophicLiveViewSequence,
    _presence,
)


class IsotrophicLiveViewSequence3D(IsotrophicLiveViewSequence):
    """Training batches of isotropic 3D boxes, and the box generators of
    `mp predict_3D`."""

    samples = "isotropic 3D boxes"

    def __init__(self, image_pair_queue, real_box_dim, no_log=False,
                 **kwargs):
        super().__init__(image_pair_queue, **kwargs)
        self.real_box_dim = float(real_box_dim)
        if not no_log:
            self.log()

    def log(self):
        self.logger(f"\nIs validation:      {self.is_validation}")
        self.logger(f"Real box dim:       {self.real_box_dim}")
        self.logger(f"Sample dim:         {self.sample_dim}")
        self.logger(f"Batch size:         {self.batch_size}")
        self.logger(f"N fg boxes:         {self.n_fg_slices}")
        self.logger(f"Noise SD:           {self.noise_sd}")
        self.logger(f"Device:             {self.device}")

    # ------------------------------------------------------------- training
    def _draw_candidates(self, image):
        """MAX_TRIES corners (K, 3), then MAX_TRIES rotations (K, 3, 3)
        (identities without orientation noise), float32."""
        corners = np.stack([
            geometry.random_box_placement(image.real_shape, self.real_box_dim)
            for _ in range(MAX_TRIES)]).astype(np.float32)
        if self.noise_sd:
            rots = np.stack([geometry.random_box_rotation(self.noise_sd)
                             for _ in range(MAX_TRIES)]).astype(np.float32)
        else:
            rots = np.broadcast_to(np.eye(3, dtype=np.float32),
                                   (MAX_TRIES, 3, 3)).copy()
        return corners, rots

    def _sample_one(self, image, has_fg_vec, has_fg_count, cur_bs):
        """The per-image path's batch element: the K candidate label boxes
        and their presence, the walk, the chosen image box. Returns
        (im (d, d, d, C), lab (d, d, d) int32, has_fg_vec,
        has_fg_count)."""
        sampler = image.interpolator
        dev = self.device
        corners, rots = self._draw_candidates(image)
        valid = tuple(int(s) for s in sampler.valid_shape)
        rot = sampler.device_rot(dev)
        labs = sample_box_batch(
            sampler.device_labels(dev), sampler.origin, sampler.spacing,
            rot, corners, self.real_box_dim, rots, self.sample_dim,
            float(image.bg_class), method="nearest",
            valid_shape=valid)[..., 0].to(torch.int32)
        presence = _presence(labs, self.n_classes).cpu().numpy()
        j, has_fg_vec, has_fg_count = self.select_candidate(
            presence, has_fg_vec, has_fg_count, cur_bs)
        im = sample_box(
            sampler.device_volume_unpacked(dev, dtype=torch.float32),
            sampler.origin, sampler.spacing, rot, corners[j],
            self.real_box_dim, rots[j], self.sample_dim,
            sampler.scaled_bg_value, valid_shape=valid)
        return im, labs[j], has_fg_vec, has_fg_count

    # -------------------------------------------------------- pooled batches
    def _start_pooled_batch(self):
        """Draw one batch's images and candidates (per element: the queue
        draw, its placements, its rotations), stage the images in the
        pool and gather the depth-0 candidate label boxes and their
        presence (not fetched)."""
        pool = self._get_pool()
        B, K = self.batch_size, MAX_TRIES
        slots, weights = [], []
        corners = np.empty((B, K, 3), np.float32)
        rots = np.empty((B, K, 3, 3), np.float32)
        for b in range(B):
            with self.image_pair_queue.get_random_image() as image:
                slots.append(pool.ensure(image))
                weights.append(image.sample_weight)
                corners[b], rots[b] = self._draw_candidates(image)
        params = pool.params_for(np.asarray(slots, np.int32))
        labs0, pres0 = self._pool_labels(pool.labels, params, corners[:, 0],
                                         rots[:, 0])
        return dict(pool=pool, params=params, weights=weights,
                    cands=(corners, rots), labs0=labs0, pres0=pres0)

    def _pool_labels(self, label_pool, params, corners, rots):
        """Nearest-gathered candidate label boxes (R, d, d, d) int32 of R
        pool rows and their class presence (R, n_classes), on the pool's
        device (the JAX package's `_pool_candidate_boxes`)."""
        labs = sample_box_batch_pool(
            label_pool, params["slots"], params["origins"],
            params["spacings"], params["rots"], corners, rots,
            self.real_box_dim, self.sample_dim, params["bg_classes"][:, None],
            method="nearest", valid_shapes=params["valid_shapes"],
        )[..., 0].to(torch.int32)
        return labs, _presence(labs, self.n_classes)

    def _pool_images(self, pool, params, corners, rots):
        """The B chosen image boxes, linear-gathered from the pool."""
        return sample_box_batch_pool(
            pool.volumes, params["slots"], params["origins"],
            params["spacings"], params["rots"], corners, rots,
            self.real_box_dim, self.sample_dim, params["fills"],
            valid_shapes=params["valid_shapes"])

    # ------------------------------------------------------------ inference
    def base_placements(self, image):
        """Corners (N, 3) float32 of the minimal box tiling of the image's
        scanner space."""
        real_dims = np.asarray(image.real_shape, np.float64)
        sample_space = np.maximum(real_dims, self.real_box_dim)
        d = sample_space - self.real_box_dim
        n_per_axis = np.ceil(sample_space / self.real_box_dim).astype(int)
        axes = [np.linspace(0, d[i], n_per_axis[i]) - sample_space[i] / 2
                for i in range(3)]
        mesh = np.meshgrid(*axes, indexing="ij")
        return np.stack([m.ravel() for m in mesh], axis=1).astype(np.float32)

    def _box_axes(self, corner):
        return tuple(np.linspace(corner[i], corner[i] + self.real_box_dim,
                                 self.sample_dim).astype(np.float32)
                     for i in range(3))

    def _extract_box(self, image, corner, rot, return_y):
        """The image box (d, d, d, C) at `corner` rotated by `rot`, and,
        when return_y and the image has labels, its label box (d, d, d)
        int32, on the sequence's device."""
        sampler = image.interpolator
        dev = self.device
        valid = tuple(int(s) for s in sampler.valid_shape)
        im = sample_box(
            sampler.device_volume_unpacked(dev, dtype=torch.float32),
            sampler.origin, sampler.spacing, sampler.device_rot(dev), corner,
            self.real_box_dim, rot, self.sample_dim, sampler.scaled_bg_value,
            valid_shape=valid)
        lab = None
        if return_y and not image.predict_mode:
            lab = sample_box(
                sampler.device_labels(dev), sampler.origin, sampler.spacing,
                sampler.device_rot(dev), corner, self.real_box_dim, rot,
                self.sample_dim, float(image.bg_class), method="nearest",
                valid_shape=valid)[..., 0].to(torch.int32)
        return im, lab

    def get_base_patches_from(self, image, return_y=False):
        """Yield (im, [lab,] corner, axes, inv_rot, total) over the base
        tiles."""
        placements = self.base_placements(image)
        eye = np.eye(3, dtype=np.float32)
        for corner in placements:
            im, lab = self._extract_box(image, corner, eye, return_y)
            axes = self._box_axes(corner)
            if return_y:
                yield im, lab, corner, axes, eye, len(placements)
            else:
                yield im, corner, axes, eye, len(placements)

    def get_N_random_patches_from(self, image, N, return_y=False):
        """Yield (im, [lab,] corner, axes, inv_rot) of N random boxes (per
        box: the placement, then the rotation)."""
        for _ in range(int(N)):
            corner = geometry.random_box_placement(
                image.real_shape, self.real_box_dim).astype(np.float32)
            if self.noise_sd:
                rot = geometry.random_box_rotation(
                    self.noise_sd).astype(np.float32)
            else:
                rot = np.eye(3, dtype=np.float32)
            im, lab = self._extract_box(image, corner, rot, return_y)
            axes = self._box_axes(corner)
            inv_rot = np.linalg.inv(rot.astype(np.float64)).astype(np.float32)
            if return_y:
                yield im, lab, corner, axes, inv_rot
            else:
                yield im, corner, axes, inv_rot
