"""Multi-planar training batches of oblique 2D slices, sampled on a device.

Port of the training half of `multiplanarunet_tpu/sequences/
multi_planar.py` (`IsotrophicLiveViewSequence` and the per-image path of
`IsotrophicLiveViewSequence2D`). For each element of a batch:

1. a random image of the queue; MAX_TRIES = 10 candidate (view, offset,
   orientation noise) tuples drawn on the host with numpy, in the JAX
   package's order;
2. one nearest gather of all candidate label planes from the labels
   staged on the device, reduced to per-candidate class presence, and one
   fetch of that (10, n_classes) presence to the host;
3. the reference's accept/retry rules (fg quota, force_all_fg) walk the
   candidates on the host and pick one;
4. one linear gather of the chosen image plane from the scaled volume
   staged on the device.

Then the batch is augmented on the device (Elastic2D), labels are cropped
by `label_crop` and given a trailing axis. Batches are (X (B, d, d, C)
float32, y (B, d, d, 1), w (B,) float32 numpy) on the sequence's device;
y is int32, or float32 after an augmenter, as in the JAX package.

The JAX package's pooled sampler (a device-resident volume pool with
fused candidate walks, built for a remote TPU transport) is not ported;
the port has this one path.
"""

from __future__ import annotations

import numpy as np
import torch

from multiplanarunet_tpu_torch._device import resolve_device
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.ops import geometry
from multiplanarunet_tpu_torch.ops.interp import (
    sample_plane,
    sample_plane_batch,
)
from multiplanarunet_tpu_torch.sequences.base_sequence import BaseSequence

MAX_TRIES = 10  # candidate count; the reference's retry budget


def candidate_label_slices(labels_vol, origin, spacing, rot, bases, offsets,
                           span, dim, bg_class, n_classes, valid_shape):
    """Nearest-gather the K candidate label planes of one image and their
    class presence. Returns (labs (K, d, d) int32 on the labels' device,
    presence (K, n_classes) bool numpy, fetched)."""
    labs = sample_plane_batch(
        labels_vol, origin, spacing, rot, bases, offsets, span, dim,
        fill=float(bg_class), method="nearest", valid_shape=valid_shape,
    )[..., 0].to(torch.int32)
    K = labs.shape[0]
    # classes outside [0, n_classes) land in a spare column, dropped
    idx = torch.where((labs >= 0) & (labs < n_classes), labs, n_classes)
    presence = torch.zeros((K, n_classes + 1), dtype=torch.bool,
                           device=labs.device)
    presence.scatter_(1, idx.reshape(K, -1).long(), True)
    return labs, presence[:, :n_classes].cpu().numpy()


class IsotrophicLiveViewSequence(BaseSequence):
    """Shared batch logic: fg quotas, label crop, augment, reshape."""

    def __init__(self, image_pair_queue, dim, batch_size, n_classes,
                 real_space_span=None, noise_sd=0.0, force_all_fg="auto",
                 fg_batch_fraction=0.50, label_crop=None, logger=None,
                 is_validation=False, list_of_augmenters=None,
                 flatten_y=False, device=None, **kwargs):
        super().__init__()
        self.logger = logger or ScreenLogger()
        self.image_pair_queue = image_pair_queue
        self.sample_dim = int(dim)
        self.n_classes = int(n_classes)
        self.real_space_span = real_space_span
        self.is_validation = is_validation
        self.noise_sd = 0.0 if is_validation else noise_sd
        self.list_of_augmenters = None if is_validation else list_of_augmenters
        self.batch_size = batch_size
        self.flatten_y = flatten_y
        self.force_all_fg_switch = force_all_fg
        self.fg_batch_fraction = fg_batch_fraction
        self.fg_classes = np.arange(1, self.n_classes)
        if self.fg_classes.shape[0] == 0:
            self.fg_classes = np.array([1])
        self.label_crop = (np.array([[0, 0], [0, 0]])
                           if label_crop is None else np.asarray(label_crop))
        self.device = resolve_device(device)

    # ------------------------------------------------------------ fg quotas
    @property
    def n_fg_slices(self):
        """Minimum number of batch elements that must contain foreground."""
        return int(np.ceil(self.batch_size * self.fg_batch_fraction))

    @property
    def force_all_fg(self):
        """Force >= 1 voxel of every fg class somewhere in the batch when the
        batch has enough slots ('auto' semantics of the reference)."""
        if (isinstance(self.force_all_fg_switch, str)
                and self.force_all_fg_switch.lower() == "auto"):
            return self.batch_size > len(self.fg_classes)
        return bool(self.force_all_fg_switch)

    def _accepts_candidate(self, presence_row, is_last, has_fg_vec,
                           has_fg_count, cur_bs):
        """The reference's accept/retry rules on one candidate's class
        presence. Returns (accept, new_has_fg_vec, fg_change)."""
        cand_classes = presence_row[self.fg_classes]
        if self.force_all_fg and not is_last:
            new_mask = has_fg_vec | cand_classes
            slots_left = self.batch_size - cur_bs
            if not new_mask.all() and (~new_mask).sum() >= slots_left:
                # The candidate leaves some class unfillable: reject
                return False, has_fg_vec, 0
            has_fg_vec = new_mask
        if cand_classes.any():
            return True, has_fg_vec, 1
        slots_left = self.batch_size - cur_bs
        if (self.n_fg_slices - has_fg_count) < slots_left:
            return True, has_fg_vec, 0
        return is_last, has_fg_vec, 0

    def select_candidate(self, presence, has_fg_vec, has_fg_count, cur_bs):
        """Walk the K candidates as the reference's retry loop does; return
        (chosen index, updated vec, updated count)."""
        K = presence.shape[0]
        for t in range(K):
            accept, has_fg_vec, fg_change = self._accepts_candidate(
                presence[t], t + 1 == K, has_fg_vec, has_fg_count, cur_bs)
            if accept:
                return t, has_fg_vec, has_fg_count + fg_change
        return K - 1, has_fg_vec, has_fg_count  # pragma: no cover

    # ------------------------------------------------------- batch assembly
    def augment(self, batch_x, batch_y, batch_w, bg_values):
        if self.list_of_augmenters:
            for aug in self.list_of_augmenters:
                batch_x, batch_y, batch_w = aug(
                    batch_x, batch_y, batch_w=batch_w, bg_values=bg_values)
        return batch_x, batch_y, batch_w

    def prepare_batches(self, batch_x, batch_y, batch_w):
        batch_w = np.asarray(batch_w, np.float32)
        (l0, h0), (l1, h1) = self.label_crop
        if self.label_crop.sum() != 0:
            batch_y = batch_y[:, l0:batch_y.shape[1] - h0,
                              l1:batch_y.shape[2] - h1]
        if self.flatten_y:
            batch_y = batch_y.reshape(batch_y.shape[0], -1, 1)
        elif batch_y.shape[-1] != 1:
            batch_y = batch_y[..., None]
        return batch_x, batch_y, batch_w


class IsotrophicLiveViewSequence2D(IsotrophicLiveViewSequence):
    """Training batches of oblique 2D slices."""

    def __init__(self, image_pair_queue, views, no_log=False, **kwargs):
        super().__init__(image_pair_queue, **kwargs)
        self.views = np.asarray(views)
        if not no_log:
            self.log()

    def log(self):
        self.logger(f"\nIs validation:               {self.is_validation}")
        self.logger(f"Using real space span:       {self.real_space_span}")
        self.logger(f"Using sample dim:            {self.sample_dim}")
        self.logger(f"Using real space sample res: "
                    f"{self.real_space_span / self.sample_dim}")
        self.logger(f"N fg slices:                 {self.n_fg_slices}")
        self.logger(f"Batch size:                  {self.batch_size}")
        self.logger(f"Force all FG:                {self.force_all_fg}")
        self.logger(f"Noise SD:                    {self.noise_sd}")
        self.logger(f"Augmenters:                  {self.list_of_augmenters}")
        self.logger(f"Device:                      {self.device}")

    def _sample_slice_from(self, image, has_fg_vec, has_fg_count, cur_bs):
        """The reference's 10-try slice loop with the candidates gathered
        at once. Returns (im (d, d, C), lab (d, d) int32, has_fg_vec,
        has_fg_count)."""
        sampler = image.interpolator
        dev = self.device
        span = float(self.real_space_span)
        half = span // 2

        view_idx = np.random.randint(0, len(self.views), MAX_TRIES)
        bases = geometry.plane_basis_batch(self.views[view_idx],
                                           noise_sd=self.noise_sd)
        offsets = np.random.uniform(-half, half, MAX_TRIES).astype(np.float32)

        valid = tuple(int(s) for s in sampler.valid_shape)
        rot = sampler.device_rot(dev)
        labs, presence = candidate_label_slices(
            sampler.device_labels(dev), sampler.origin, sampler.spacing, rot,
            bases, offsets, span, self.sample_dim, image.bg_class,
            self.n_classes, valid)
        j, has_fg_vec, has_fg_count = self.select_candidate(
            presence, has_fg_vec, has_fg_count, cur_bs)
        im = sample_plane(
            sampler.device_volume_unpacked(dev, dtype=torch.float32),
            sampler.origin, sampler.spacing, rot, bases[j], float(offsets[j]),
            span, self.sample_dim, sampler.scaled_bg_value,
            valid_shape=valid)
        return im, labs[j], has_fg_vec, has_fg_count

    def __getitem__(self, idx):
        self.seed()
        has_fg_count = 0
        has_fg_vec = np.zeros(len(self.fg_classes), bool)
        xs, ys, ws, bgs = [], [], [], []
        for _ in range(self.batch_size):
            with self.image_pair_queue.get_random_image() as image:
                im, lab, has_fg_vec, has_fg_count = self._sample_slice_from(
                    image, has_fg_vec, has_fg_count, len(ys))
                xs.append(im)
                ys.append(lab)
                ws.append(image.sample_weight)
                bgs.append(np.asarray(image.interpolator.scaled_bg_value))
        batch_x, batch_y, batch_w = self.augment(
            torch.stack(xs), torch.stack(ys), np.asarray(ws, np.float32),
            np.stack(bgs))
        return self.prepare_batches(batch_x, batch_y, batch_w)
