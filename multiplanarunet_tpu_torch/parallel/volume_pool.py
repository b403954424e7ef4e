"""DeviceVolumePool: resident training volumes stacked in one device tensor.

Port of `multiplanarunet_tpu/parallel/volume_pool.py`. With every
resident volume zero-padded to one bucket shape and stacked as a
(capacity, X, Y, Z, C) float32 tensor, a whole batch of planes from
different subjects extracts in one gather indexed by slot
(`ops.interp.sample_plane_batch_pool`): the flat index gains a slot
stride. The pooled sampler then needs two host synchronisations per
batch instead of one per batch element.

Labels are stored as uint8 (capacity, X, Y, Z, 1): the port's ImagePair
reads labels as uint8 already, the nearest gather copies values, and the
bg-class fill is exact for a bg class in [0, 255] (`ensure` checks
both). That is a quarter of the JAX package's float32 label pool.

Slots carry per-image sampling parameters (origin, spacing, rotation,
fill, bg class, valid extent) in host arrays; `params_for` gathers them
per batch. `ensure` copies the sampler's host-side scaled volume into its
slot; the per-sampler staged tensors (`VolumeSampler.device_*`) are not
built, so the pool is the only device copy. The JAX package's
corner-packed twin (`pack_volumes`) is not ported.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

LABEL_DTYPE = torch.uint8


class DeviceVolumePool:
    """Fixed-capacity pool of staged (scaled) volumes and label volumes on
    `device`."""

    def __init__(self, shape, n_channels, capacity, device):
        self.shape = tuple(int(s) for s in shape)  # common padded (X, Y, Z)
        self.n_channels = int(n_channels)
        self.capacity = int(capacity)
        self.device = torch.device(device)
        self._volumes = torch.zeros(
            (self.capacity,) + self.shape + (self.n_channels,),
            dtype=torch.float32, device=self.device)
        self._labels = torch.zeros((self.capacity,) + self.shape + (1,),
                                   dtype=LABEL_DTYPE, device=self.device)
        # per-slot params (host mirrors, gathered per batch)
        self.origins = np.zeros((self.capacity, 3), np.float32)
        self.spacings = np.ones((self.capacity, 3), np.float32)
        self.rots = np.tile(np.eye(3, dtype=np.float32),
                            (self.capacity, 1, 1))
        self.fills = np.zeros((self.capacity, self.n_channels), np.float32)
        self.bg_classes = np.zeros((self.capacity,), np.float32)
        self.valid_shapes = np.ones((self.capacity, 3), np.int32)
        self._slot_of = {}
        self._order = []  # LRU, oldest first
        self._lock = threading.Lock()
        self._last_read = None  # CUDA event after the last batch's gathers

    @classmethod
    def shape_for(cls, images, bucket=32):
        """Common padded shape covering every image (bucket multiples)."""
        dims = np.stack([np.asarray(im.shape[:3]) for im in images])
        maxd = dims.max(axis=0)
        return tuple(int(max(bucket, -(-d // bucket) * bucket)) for d in maxd)

    @property
    def nbytes(self):
        """Device bytes of the pool: capacity x padded shape x (C x 4 + 1)."""
        return sum(t.numel() * t.element_size()
                   for t in (self._volumes, self._labels))

    # -------------------------------------------------------------- staging
    def mark_read(self):
        """Record, on the current stream, that the batches sampled so far
        have queued their last gather from the pool. The next staging, on
        whatever stream it runs, waits for this point before it overwrites
        a slot: the sampler's stream is new each epoch, so stream order
        alone does not cover a gather still running on the last one."""
        if self.device.type == "cuda":
            self._last_read = torch.cuda.Event()
            self._last_read.record(torch.cuda.current_stream(self.device))

    def _stage(self, dst, arr):
        """Copy the host array (x, y, z, c) into the slot view dst
        (X, Y, Z, c), zero-padded at the high ends, after the gathers
        `mark_read` recorded."""
        if self._last_read is not None:
            torch.cuda.current_stream(self.device).wait_event(self._last_read)
        x, y, z = arr.shape[:3]
        if (x, y, z) != self.shape:
            dst.zero_()
        dst[:x, :y, :z].copy_(torch.from_numpy(np.ascontiguousarray(arr)))

    def ensure(self, image):
        """Return the slot of `image`, staging it (with LRU eviction) if
        absent. The image must be loaded and have labels. Called from the
        sampling thread only: the copy runs on that thread's current stream, after every
        gather of the batches sampled before it (stream order, and the
        event of `mark_read` across streams)."""
        with self._lock:
            return self._ensure_locked(image)

    def _ensure_locked(self, image):
        key = image.identifier
        if key in self._slot_of:
            self._order.remove(key)
            self._order.append(key)
            return self._slot_of[key]
        sampler = image.interpolator
        if sampler.labels is None:
            raise ValueError(f"Image {key} has no labels; the pool holds "
                             f"training images")
        labels = np.asarray(sampler.labels)
        bg = float(image.bg_class)
        if labels.dtype != np.uint8 and (labels.min() < 0
                                         or labels.max() > 255):
            raise ValueError(f"Image {key}: labels outside [0, 255] do not "
                             f"fit the pool's uint8 label store")
        if not 0 <= bg <= 255:
            raise ValueError(f"Image {key}: bg class {bg} outside [0, 255] "
                             f"of the pool's uint8 labels")
        if len(self._slot_of) >= self.capacity:
            evict = self._order.pop(0)
            del self._slot_of[evict]
        used = set(self._slot_of.values())
        slot = next(i for i in range(self.capacity) if i not in used)
        self._stage(self._volumes[slot], sampler.scaled_volume)
        self._stage(self._labels[slot],
                    labels.astype(np.uint8, copy=False)[..., None])
        self.origins[slot] = sampler.origin
        self.spacings[slot] = sampler.spacing
        self.rots[slot] = (np.eye(3, dtype=np.float32)
                           if sampler.rot_mat is None
                           else np.asarray(sampler.rot_mat, np.float32))
        self.fills[slot] = sampler.scaled_bg_value
        self.bg_classes[slot] = bg
        self.valid_shapes[slot] = sampler.valid_shape
        self._slot_of[key] = slot
        self._order.append(key)
        return slot

    def release(self, identifier):
        with self._lock:
            if identifier in self._slot_of:
                del self._slot_of[identifier]
                self._order.remove(identifier)

    @property
    def volumes(self):
        return self._volumes

    @property
    def grid_shape(self):
        """(X, Y, Z, C) of one pool slot."""
        return self.shape + (self.n_channels,)

    @property
    def labels(self):
        return self._labels

    def params_for(self, slots):
        """Per-sample parameter arrays for a list/array of slot indices."""
        slots = np.asarray(slots, np.int32)
        return dict(
            slots=slots,
            origins=self.origins[slots],
            spacings=self.spacings[slots],
            rots=self.rots[slots],
            fills=self.fills[slots],
            bg_classes=self.bg_classes[slots],
            valid_shapes=self.valid_shapes[slots],
        )
