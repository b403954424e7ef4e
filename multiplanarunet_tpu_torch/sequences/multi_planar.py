"""Multi-planar training batches of oblique 2D slices, sampled on a device.

Port of the training half of `multiplanarunet_tpu/sequences/
multi_planar.py` (`IsotrophicLiveViewSequence` and the pooled and
per-image paths of `IsotrophicLiveViewSequence2D`). Each batch element
is a random image of the queue and MAX_TRIES = 10 candidate (view,
offset, orientation noise) tuples drawn on the host with numpy, in the
JAX package's order; the reference's accept/retry rules (fg quota,
force_all_fg) walk the candidates' class presence on the host and pick
one; the chosen plane is linear-gathered from the scaled volume.

The pooled path (the default, as in the JAX package) keeps the queue's
images in a `DeviceVolumePool` (one (capacity, X, Y, Z, C) tensor, plus
uint8 labels) and samples a whole batch with batched gathers:

1. start: B draws of the queue, each staged into the pool if absent (LRU
   eviction); the candidates' numpy draws; one nearest gather of the B
   depth-0 candidate label planes, reduced to class presence on the
   device;
2. finish: one fetch of the depth-0 presence; the rows that the rules may
   reject gather their K-1 deeper candidates in one call, and one fetch
   of their presence; the host walk (`select_candidate`) picks each row's
   candidate; one linear gather of the B chosen image planes, the chosen
   labels selected on the device.

That is two host synchronisations per batch. The per-image path
(`use_pool = False`) stages each image's volume and labels on the device
(`VolumeSampler.device_*`) and gathers and fetches per batch element. The
path is chosen once, before the first batch, by the JAX package's rule:
per-image when the pool's capacity (the queue's max_loaded, or the
dataset size) is below both the batch size and the dataset size, or when
the dataset has no labels.

Batches are sampled one ahead of the train step by
`base_sequence.prefetched`, on a side stream, with no lookahead inside
the sequence: a batch's gathers are queued before the next batch's
`ensure` can overwrite a pool slot, so stream order keeps slots from
aliasing (and an event, `DeviceVolumePool.mark_read`, where the next
epoch samples on a new stream). Then the batch is augmented on the device (Elastic2D),
labels are cropped by `label_crop` and given a trailing axis. Batches are
(X (B, d, d, C) float32, y (B, d, d, 1), w (B,) float32 numpy) on the
sequence's device; y is int32, or float32 after an augmenter, as in the
JAX package.

For inference, `IsotrophicLiveViewSequence2D.get_view_from` samples one
view's whole plane stack from the float32 staged volume (and the label
stack, nearest), with the grid and inverse basis that
`utils.fusion.fuse_and_predict.map_real_space_pred` takes back onto the
voxels.
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
    sample_plane_batch_pool,
    sample_plane_stack,
)
from multiplanarunet_tpu_torch.parallel.volume_pool import DeviceVolumePool
from multiplanarunet_tpu_torch.sequences.base_sequence import BaseSequence
from multiplanarunet_tpu_torch.utils import trace

MAX_TRIES = 10  # candidate count; the reference's retry budget


def _presence(labs, n_classes):
    """(R, n_classes) bool class presence of R label planes (R, d, d), on
    their device; classes outside [0, n_classes) are dropped."""
    R = labs.shape[0]
    idx = torch.where((labs >= 0) & (labs < n_classes), labs, n_classes)
    presence = torch.zeros((R, n_classes + 1), dtype=torch.bool,
                           device=labs.device)
    presence.scatter_(1, idx.reshape(R, -1).long(), True)
    return presence[:, :n_classes]


def candidate_label_slices(labels_vol, origin, spacing, rot, bases, offsets,
                           span, dim, bg_class, n_classes, valid_shape):
    """Nearest-gather the K candidate label planes of one image and their
    class presence. Returns (labs (K, d, d) int32 on the labels' device,
    presence (K, n_classes) bool numpy, fetched)."""
    labs = sample_plane_batch(
        labels_vol, origin, spacing, rot, bases, offsets, span, dim,
        fill=float(bg_class), method="nearest", valid_shape=valid_shape,
    )[..., 0].to(torch.int32)
    return labs, _presence(labs, n_classes).cpu().numpy()


def pool_candidate_labels(label_pool, params, bases, offsets, span, dim,
                          n_classes):
    """Nearest-gather R candidate label planes from R pool slots in one
    call (params: `DeviceVolumePool.params_for` of the R slots). Returns
    (labs (R, d, d) int32, presence (R, n_classes) bool), both on the
    pool's device and not fetched (the JAX package's
    `_pool_candidate_labels`)."""
    labs = sample_plane_batch_pool(
        label_pool, params["slots"], params["origins"], params["spacings"],
        params["rots"], bases, offsets, span, dim,
        params["bg_classes"][:, None], method="nearest",
        valid_shapes=params["valid_shapes"])[..., 0].to(torch.int32)
    return labs, _presence(labs, n_classes)


class IsotrophicLiveViewSequence(BaseSequence):
    """Shared batch logic: fg quotas, the path choice and the volume pool,
    label crop, augment, reshape. Subclasses name what they sample
    (`samples`) and implement `_start_pooled_batch` /
    `_finish_pooled_batch` (the pooled path) and `_sample_one`, the
    per-image path's draw of one batch element."""

    samples = None

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
        # True: the pooled path unless the first batch's path choice rules
        # it out; False: the per-image path
        self.use_pool = True
        self._path_chosen = False
        self._pool = None

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

    def walk_candidates(self, pres0, pres_rest, s_pos):
        """The sequential accept/retry walk over a batch (reference
        statistics). pres0 (B, n_classes): each row's first candidate;
        pres_rest (R, K-1, n_classes): the deeper candidates of the rows b
        with s_pos[b] >= 0 (their row in it); a row with s_pos[b] < 0 must
        accept its first candidate. Returns the chosen candidate per row
        (B,) int64."""
        B = pres0.shape[0]
        K = MAX_TRIES if pres_rest is None else pres_rest.shape[1] + 1
        has_fg_count = 0
        has_fg_vec = np.zeros(len(self.fg_classes), bool)
        chosen_t = np.empty(B, np.int64)
        for b in range(B):
            if s_pos[b] < 0:
                accept, has_fg_vec, fg_change = self._accepts_candidate(
                    pres0[b], K == 1, has_fg_vec, has_fg_count, b)
                if not accept:
                    raise AssertionError(
                        "a first candidate outside the phase-2 rows was "
                        "rejected")
                has_fg_count += fg_change
                chosen_t[b] = 0
            else:
                presence_b = np.concatenate(
                    [pres0[b:b + 1], pres_rest[s_pos[b]]])
                chosen_t[b], has_fg_vec, has_fg_count = \
                    self.select_candidate(presence_b, has_fg_vec,
                                          has_fg_count, b)
        return chosen_t

    # ------------------------------------------------------- the pooled path
    def pool_capacity(self):
        """Slots of the volume pool: the queue's max_loaded (a
        LimitationQueue's bound), else the dataset size."""
        dataset = self.image_pair_queue.dataset
        return min(len(dataset),
                   getattr(self.image_pair_queue, "max_loaded", None)
                   or len(dataset))

    def _choose_path(self):
        """Decide once, before the first batch, between the pooled and
        the per-image path (the JAX package's rule) and log the choice."""
        self._path_chosen = True
        if not self.use_pool:
            self.logger("Sampler: per-image path (use_pool = False)")
            return
        dataset = self.image_pair_queue.dataset
        capacity = self.pool_capacity()
        reason = None
        if getattr(dataset, "predict_mode", False):
            reason = "the dataset has no labels"
        elif capacity < self.batch_size and capacity < len(dataset):
            # A batch may draw more distinct images than the pool holds;
            # LRU eviction could then overwrite a slot an earlier sample of
            # the same batch reads
            reason = (f"volume pool capacity {capacity} < batch size "
                      f"{self.batch_size}")
        if reason:
            self.use_pool = False
            self.logger(f"Sampler: per-image path ({reason})")
        else:
            self.logger(f"Sampler: pooled path ({self.samples}; "
                        f"DeviceVolumePool of {capacity} slots on "
                        f"{self.device})")

    def _get_pool(self):
        """The DeviceVolumePool over the queue's dataset, built at first
        use."""
        if self._pool is None:
            dataset = self.image_pair_queue.dataset
            self._pool = DeviceVolumePool(
                DeviceVolumePool.shape_for(dataset.images),
                dataset.images[0].n_channels, self.pool_capacity(),
                self.device)
        return self._pool

    def _finish_pooled_batch(self, st):
        """Fetch the depth-0 presence, gather and fetch the deeper
        candidates of the rows the rules may reject (the rules provably
        accept a first candidate holding every fg class under
        force_all_fg, or any fg class without), walk the candidates on the
        host, gather the chosen images, select the chosen labels, augment
        and prepare the batch (the JAX package's host-walk finish).
        st["cands"] holds the candidates' (B, K, ...) host arrays, the
        arguments of `_pool_labels` / `_pool_images` after the params."""
        pool, params, labs0 = st["pool"], st["params"], st["labs0"]
        cands = st["cands"]
        B, K = cands[0].shape[:2]
        with trace.span("sampler.labels"):
            pres0 = st["pres0"].cpu().numpy()
            fg = pres0[:, self.fg_classes]
            maybe_rejected = ~fg.all(1) if self.force_all_fg else ~fg.any(1)
            S = np.nonzero(maybe_rejected)[0]
            s_pos = np.full(B, -1, np.int64)
            labs_rest = pres_rest = None
            if len(S) and K > 1:
                rep = np.repeat(S, K - 1)
                labs_rest, pres_rest = self._pool_labels(
                    pool.labels, {k: v[rep] for k, v in params.items()},
                    *(c[S, 1:].reshape((-1,) + c.shape[2:]) for c in cands))
                pres_rest = pres_rest.cpu().numpy().reshape(len(S), K - 1,
                                                            -1)
                s_pos[S] = np.arange(len(S))
        with trace.span("sampler.walk"):
            chosen_t = self.walk_candidates(pres0, pres_rest, s_pos)

        rows = np.arange(B)
        with trace.span("sampler.images"):
            batch_x = self._pool_images(pool, params,
                                        *(c[rows, chosen_t] for c in cands))
            pool.mark_read()
        # Chosen labels: depth-0 rows from labs0, deeper ones from the
        # phase-2 block (its row s_pos[b] * (K-1) + t - 1)
        if labs_rest is None:
            batch_y = labs0
        else:
            sel_idx = np.where(chosen_t == 0, rows,
                               B + s_pos * (K - 1) + chosen_t - 1)
            batch_y = torch.cat([labs0, labs_rest]).index_select(
                0, torch.as_tensor(sel_idx, device=labs0.device))
        with trace.span("sampler.augment", device=self.device):
            batch_x, batch_y, batch_w = self.augment(
                batch_x, batch_y, np.asarray(st["weights"], np.float32),
                params["fills"])
        return self.prepare_batches(batch_x, batch_y, batch_w)

    def __getitem__(self, idx):
        self.seed()
        if not self._path_chosen:
            self._choose_path()
        if self.use_pool:
            with trace.span("sampler.draw"):
                st = self._start_pooled_batch()
            return self._finish_pooled_batch(st)
        has_fg_count = 0
        has_fg_vec = np.zeros(len(self.fg_classes), bool)
        xs, ys, ws, bgs = [], [], [], []
        for _ in range(self.batch_size):
            with self.image_pair_queue.get_random_image() as image:
                im, lab, has_fg_vec, has_fg_count = self._sample_one(
                    image, has_fg_vec, has_fg_count, len(ys))
                xs.append(im)
                ys.append(lab)
                ws.append(image.sample_weight)
                bgs.append(np.asarray(image.interpolator.scaled_bg_value))
        batch_x, batch_y, batch_w = self.augment(
            torch.stack(xs), torch.stack(ys), np.asarray(ws, np.float32),
            np.stack(bgs))
        return self.prepare_batches(batch_x, batch_y, batch_w)

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

    samples = "oblique 2D planes"

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

    def _sample_one(self, image, has_fg_vec, has_fg_count, cur_bs):
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

    def _start_pooled_batch(self):
        """Draw one batch's images and randomness, stage the images in the
        pool and gather the depth-0 candidate labels and their presence
        (not fetched). The numpy draws come in the JAX package's order: B
        queue draws, the view indices, the plane-basis noise, the
        offsets."""
        pool = self._get_pool()
        B, K = self.batch_size, MAX_TRIES
        span = float(self.real_space_span)
        half = span // 2

        slots, weights = [], []
        for _ in range(B):
            with self.image_pair_queue.get_random_image() as image:
                slots.append(pool.ensure(image))
                weights.append(image.sample_weight)
        slots = np.asarray(slots, np.int32)

        view_idx = np.random.randint(0, len(self.views), B * K)
        bases = geometry.plane_basis_batch(
            self.views[view_idx], noise_sd=self.noise_sd).reshape(B, K, 3, 3)
        offsets = np.random.uniform(-half, half, B * K).astype(
            np.float32).reshape(B, K)
        params = pool.params_for(slots)
        with trace.span("sampler.labels"):
            labs0, pres0 = self._pool_labels(pool.labels, params,
                                             bases[:, 0], offsets[:, 0])
        return dict(pool=pool, params=params, weights=weights,
                    cands=(bases, offsets), labs0=labs0, pres0=pres0)

    def _pool_labels(self, label_pool, params, bases, offsets):
        """Nearest-gathered candidate label planes of R pool rows (params
        of those rows, bases (R, 3, 3), offsets (R,)) and their class
        presence, on the pool's device."""
        return pool_candidate_labels(
            label_pool, params, bases, offsets, float(self.real_space_span),
            self.sample_dim, self.n_classes)

    def _pool_images(self, pool, params, bases, offsets):
        """The B chosen image planes, linear-gathered from the pool."""
        return sample_plane_batch_pool(
            pool.volumes, params["slots"], params["origins"],
            params["spacings"], params["rots"], bases, offsets,
            float(self.real_space_span), self.sample_dim, params["fills"],
            valid_shapes=params["valid_shapes"])

    # ------------------------------------------------------------ inference
    def plane_offsets(self, image, n_planes):
        """The plane offsets of an n_planes spec ('same', 'same+N',
        'by_radius' or a count) at this sequence's span and dim
        (`ops.geometry.plane_offsets`, which the predictor shares)."""
        return geometry.plane_offsets(image, n_planes, self.real_space_span,
                                      self.sample_dim)

    def get_view_from(self, image, view, n_planes):
        """The full plane stack of one view over an image, on this
        sequence's device: (X (d, d, P, C) float32 scaled, y (d, d, P)
        int32 or None in predict mode, (real_axis, real_axis, offsets),
        inv_basis (3, 3) float32), the JAX package's tuple. X is
        linear-gathered from the float32 staged volume
        (`VolumeSampler.device_volume`), y nearest from the labels with
        the image's bg_class as fill."""
        offsets = self.plane_offsets(image, n_planes)
        basis = geometry.plane_basis(view, noise_sd=0.0)
        sampler = image.interpolator
        dev = self.device
        span = float(self.real_space_span)
        rot = sampler.device_rot(dev)
        valid = tuple(int(s) for s in sampler.valid_shape)
        X = sample_plane_stack(
            sampler.device_volume(dev), sampler.origin, sampler.spacing, rot,
            basis, offsets, span, self.sample_dim, sampler.scaled_bg_value,
            valid_shape=valid)
        y = None
        if not image.predict_mode:
            y = sample_plane_stack(
                sampler.device_labels(dev), sampler.origin, sampler.spacing,
                rot, basis, offsets, span, self.sample_dim,
                float(image.bg_class), method="nearest",
                valid_shape=valid)[..., 0].to(torch.int32)
        real_axis = geometry.plane_axis(self.real_space_span, self.sample_dim)
        inv_basis = np.linalg.inv(basis.astype(np.float64)).astype(np.float32)
        return X, y, (real_axis, real_axis, offsets), inv_basis
