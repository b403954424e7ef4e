"""Per-image volume staging on a device, for the predictor and the
training sampler.

Port of the device-staging half of
`multiplanarunet_tpu/image/volume_sampler.py:VolumeSampler`: the centered
voxel-axis geometry (origin, spacing, alignment rotation), the scaled
volume (cached on the host), and the bucket-padded volume as a cached
tensor on a device, either plain (X, Y, Z, C) for the shear resampler and
the training sampler or corner-packed (X, Y, Z, 8, C) for the gather
resampler. With quantize=True the host ships per-channel affine uint8
codes (half the bytes of bf16) and the card dequantises them to bf16.
For training, the labels are staged too (`device_labels`, float32
(X, Y, Z, 1), the nearest-gather source) with the image's background
class (`bg_class`), and `device_rot` gives the alignment rotation as a
tensor. `device_volume` stages the scaled volume in float32 (the source
of `get_view_from` and `predict_single`'s paths), cached apart from the
bf16 forms. The host path (`apply_rotation`, `intrp_image`,
`intrp_labels`, `__call__`) interpolates the RAW image and the labels at
a (3, ...) query mesh in numpy (`ops.interp.grid_gather_np`), as the JAX
package's does: scaling is the caller's.
"""

from __future__ import annotations

import numpy as np
import torch

from multiplanarunet_tpu_torch.ops import geometry
from multiplanarunet_tpu_torch.ops.interp import grid_gather_np, pack_corners


class VolumeSampler:
    """image: (X, Y, Z, C) array; scaler: any object with `.transform`
    taking and returning (X, Y, Z, C) arrays, or None; labels: (X, Y, Z)
    integer array or None.

    The positional order is the port's, (image, affine, bg_value, scaler,
    labels, bg_class); the JAX package's is (image, labels, affine,
    bg_value, bg_class, scaler). Pass the labels by keyword to write a
    call both packages read alike."""

    def __init__(self, image, affine, bg_value=0.0, scaler=None, labels=None,
                 bg_class=0):
        if image.ndim != 4:
            raise ValueError(
                f"Image must be rank-4 (X,Y,Z,C); got shape {image.shape}. "
                f"Use np.expand_dims(img, -1) for single-channel volumes.")
        self.image = image
        self.labels = labels
        self.bg_class = int(bg_class)
        self.affine = np.asarray(affine)
        self.n_channels = image.shape[-1]
        self.scaler = scaler
        if not isinstance(bg_value, (list, tuple, np.ndarray)):
            bg_value = [bg_value] * self.n_channels
        if len(bg_value) != self.n_channels:
            raise ValueError(
                f"bg_value must have one entry per channel "
                f"({self.n_channels}), got {bg_value}")
        self.bg_value = list(bg_value)
        self.origin, self.spacing, self.rot_mat = \
            geometry.voxel_axes_origin_spacing(image.shape, self.affine)
        self._scaled_cache = None
        self._codes = None    # (bucket, (codes, step, vmin))
        self._staged = None   # ((form, device, bucket, dtype, quantize), t)
        self._labels_staged = None  # ((device, bucket), t)
        self._device_volume = None  # ((device, bucket, dtype), t)

    # ------------------------------------------------------------- host path
    def apply_rotation(self, mgrid):
        """A (3, ...) stacked query mesh rotated onto the aligned grid
        (unchanged when the affine is axis-aligned)."""
        if self.rot_mat is None:
            return mgrid
        mgrid = np.asarray(mgrid)
        pts = geometry.mgrid_to_points(mgrid)
        return geometry.points_to_mgrid(
            pts @ np.asarray(self.rot_mat, np.float32).T, mgrid.shape[1:])

    def _points_from_mgrid(self, mgrid, apply_rot):
        mgrid = np.asarray(mgrid)
        if apply_rot:
            mgrid = self.apply_rotation(mgrid)
        return np.moveaxis(mgrid, 0, -1)

    @staticmethod
    def _squeeze_unit(a, axes_of):
        """a without the unit axes among its first `axes_of` axes."""
        unit = tuple(i for i, s in enumerate(a.shape[:axes_of]) if s == 1)
        return np.squeeze(a, axis=unit) if unit else a

    def intrp_image(self, mgrid, apply_rot=True):
        """The RAW image linear-interpolated at a (3, ...) query mesh,
        bg_value out of bounds; unit axes of the mesh dropped."""
        out = grid_gather_np(
            self.image, self.origin, self.spacing,
            self._points_from_mgrid(mgrid, apply_rot), method="linear",
            fill=np.asarray(self.bg_value, np.float32))
        return self._squeeze_unit(out, out.ndim - 1)

    def intrp_labels(self, mgrid, apply_rot=True):
        """The labels nearest-interpolated at a (3, ...) query mesh,
        bg_class out of bounds, as uint8 (uint16 past 255); None without
        labels."""
        if self.labels is None:
            return None
        lab = grid_gather_np(
            self.labels[..., None].astype(np.float32), self.origin,
            self.spacing, self._points_from_mgrid(mgrid, apply_rot),
            method="nearest", fill=float(self.bg_class))[..., 0]
        return self._cast_labels(self._squeeze_unit(lab, lab.ndim))

    def __call__(self, mgrid):
        """(image, labels) at a (3, ...) query mesh, rotated once."""
        mgrid = self.apply_rotation(np.asarray(mgrid))
        return (self.intrp_image(mgrid, apply_rot=False),
                self.intrp_labels(mgrid, apply_rot=False))

    @staticmethod
    def _cast_labels(lab):
        info = np.iinfo(np.uint8)
        if np.all((lab >= info.min) & (lab <= info.max)):
            return lab.astype(np.uint8)
        return lab.astype(np.uint16)

    # ------------------------------------------------------------- host side
    @property
    def scaled_volume(self):
        """Raw volume with the per-channel scaler applied (float32,
        cached)."""
        if self._scaled_cache is None:
            vol = self.image if self.scaler is None else \
                self.scaler.transform(self.image)
            self._scaled_cache = np.ascontiguousarray(vol, dtype=np.float32)
        return self._scaled_cache

    @property
    def scaled_bg_value(self):
        """bg fill in scaled units: transform([bg_value]) per channel."""
        if self.scaler is None:
            return np.asarray(self.bg_value, np.float32)
        bg = np.asarray(self.bg_value, np.float32).reshape(1, 1, 1, -1)
        return self.scaler.transform(bg).reshape(-1).astype(np.float32)

    @property
    def valid_shape(self):
        """True spatial extent (3,) int32."""
        return np.asarray(self.image.shape[:3], np.int32)

    def padded_shape(self, bucket=32):
        """Spatial shape after zero-padding each axis up to a multiple of
        `bucket` at the high end."""
        if not bucket:
            return tuple(int(s) for s in self.image.shape[:3])
        return tuple(max(bucket, -(-int(n) // bucket) * bucket)
                     for n in self.image.shape[:3])

    def quantized_codes(self, bucket=32):
        """Per-channel affine uint8 quantization of the scaled volume,
        padded to the bucket with each channel's code for 0.0 (the zero
        pad of the float staging). Returns (codes uint8 (X, Y, Z, C),
        step (C,) f32, vmin (C,) f32), cached; dequantization is
        codes * step + vmin, max abs error step/2 = range/510."""
        key = int(bucket or 0)
        if self._codes is None or self._codes[0] != key:
            vol = self.scaled_volume
            vmin = vol.min(axis=(0, 1, 2)).astype(np.float32)
            vmax = vol.max(axis=(0, 1, 2)).astype(np.float32)
            step = np.maximum((vmax - vmin) / np.float32(255.0),
                              np.float32(1e-12))
            q = np.clip(np.rint((vol - vmin) / step), 0, 255).astype(np.uint8)
            target = self.padded_shape(bucket)
            if tuple(target) != vol.shape[:3]:
                q0 = np.clip(np.rint((np.float32(0.0) - vmin) / step), 0,
                             255).astype(np.uint8)
                full = np.empty(tuple(target) + (vol.shape[3],), np.uint8)
                full[...] = q0
                full[:q.shape[0], :q.shape[1], :q.shape[2]] = q
                q = full
            self._codes = (key, (q, step, vmin))
        return self._codes[1]

    def prepare_host(self, quantize=False, bucket=32):
        """Do the host half of staging ahead of time (scaling, and the
        uint8 codes when quantize), so a later device_volume_* call only
        copies."""
        if quantize:
            self.quantized_codes(bucket)
        else:
            self.scaled_volume  # noqa: B018 (fills the cache)

    # ----------------------------------------------------------- device side
    def _dense(self, device, bucket, dtype, quantize):
        """The scaled, bucket-padded (X, Y, Z, C) volume on `device`."""
        if quantize:
            q, step, vmin = self.quantized_codes(bucket)
            codes = torch.from_numpy(q).to(device)
            step = torch.from_numpy(step).to(device)
            vmin = torch.from_numpy(vmin).to(device)
            return (codes.float() * step + vmin).to(dtype)
        vol = torch.from_numpy(self.scaled_volume).to(device=device,
                                                      dtype=dtype)
        pads = []
        for n, p in zip(vol.shape[:3], self.padded_shape(bucket)):
            pads = [0, p - n] + pads  # F.pad lists the last axis first
        return torch.nn.functional.pad(vol, [0, 0] + pads)

    def _cached(self, form, device, bucket, dtype, quantize):
        key = (form, torch.device(device), int(bucket or 0), dtype,
               bool(quantize))
        if self._staged is None or self._staged[0] != key:
            # one staged form at a time per image
            self._staged = None
            vol = self._dense(device, bucket, dtype, quantize)
            self._staged = (key, pack_corners(vol) if form == "packed"
                            else vol)
        return self._staged[1]

    def device_volume_unpacked(self, device, bucket=32, dtype=torch.bfloat16,
                               quantize=False):
        """The scaled (X, Y, Z, C) volume zero-padded to the bucket, as a
        tensor of `dtype` on `device` (cached until the key changes), for
        the shear resampler."""
        return self._cached("unpacked", device, bucket, dtype, quantize)

    def device_volume_packed(self, device, bucket=32, dtype=torch.bfloat16,
                             quantize=False):
        """The corner-packed (X, Y, Z, 8, C) form of the same volume
        (`ops.interp.pack_corners`, expanded on the device), for the
        gather resampler. Cached like the unpacked form."""
        return self._cached("packed", device, bucket, dtype, quantize)

    def device_volume(self, device, dtype=None, bucket=32):
        """The scaled (X, Y, Z, C) volume zero-padded to the bucket, as a
        float32 tensor (or `dtype`) on `device`, cached apart from the
        unpacked and packed forms (the JAX package's `device_volume`)."""
        dtype = torch.float32 if dtype is None else dtype
        key = (torch.device(device), int(bucket or 0), dtype)
        if self._device_volume is None or self._device_volume[0] != key:
            self._device_volume = None
            self._device_volume = (key, self._dense(device, bucket, dtype,
                                                    False))
        return self._device_volume[1]

    def device_labels(self, device, bucket=32):
        """The labels as float32 (X, Y, Z, 1) zero-padded to the bucket on
        `device` (cached), or None without labels."""
        if self.labels is None:
            return None
        key = (torch.device(device), int(bucket or 0))
        if self._labels_staged is None or self._labels_staged[0] != key:
            self._labels_staged = None
            lab = torch.from_numpy(np.ascontiguousarray(self.labels))
            lab = lab.to(device).float()[..., None]
            pads = []
            for n, p in zip(lab.shape[:3], self.padded_shape(bucket)):
                pads = [0, p - n] + pads
            self._labels_staged = (key, torch.nn.functional.pad(
                lab, [0, 0] + pads))
        return self._labels_staged[1]

    def device_rot(self, device):
        """The scanner -> grid alignment rotation as a float32 (3, 3)
        tensor (the identity when the affine is axis-aligned)."""
        rot = np.eye(3) if self.rot_mat is None else self.rot_mat
        return torch.as_tensor(np.asarray(rot, np.float32), device=device)

    def unload_device(self):
        """Drop every staged tensor and the host caches."""
        self._device_volume = None
        self._labels_staged = None
        self._staged = None
        self._codes = None
        self._scaled_cache = None
