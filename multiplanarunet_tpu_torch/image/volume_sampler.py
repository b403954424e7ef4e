"""Per-image volume staging for the predictor (device path only).

Port of the device-staging half of
`multiplanarunet_tpu/image/volume_sampler.py:VolumeSampler`: the centered
voxel-axis geometry (origin, spacing, alignment rotation) and the scaled,
bucket-padded volume as a cached tensor on a given device. The host
interpolation path and uint8 staging are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from multiplanarunet_tpu_torch.ops import geometry


class VolumeSampler:
    """image: (X, Y, Z, C) array; scaler: any object with `.transform`
    taking and returning (X, Y, Z, C) arrays, or None."""

    def __init__(self, image, affine, bg_value=0.0, scaler=None):
        if image.ndim != 4:
            raise ValueError(
                f"Image must be rank-4 (X,Y,Z,C); got shape {image.shape}. "
                f"Use np.expand_dims(img, -1) for single-channel volumes.")
        self.image = image
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
        self._staged = None
        self._staged_key = None

    @property
    def scaled_volume(self):
        """Raw volume with the per-channel scaler applied (float32)."""
        vol = self.image if self.scaler is None else \
            self.scaler.transform(self.image)
        return np.ascontiguousarray(vol, dtype=np.float32)

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

    def device_volume_unpacked(self, device, bucket=32, dtype=torch.bfloat16):
        """The scaled (X, Y, Z, C) volume zero-padded to the bucket, as a
        tensor of `dtype` on `device` (cached until the key changes)."""
        key = (torch.device(device), int(bucket or 0), dtype)
        if self._staged_key != key:
            vol = torch.from_numpy(self.scaled_volume).to(device=device,
                                                          dtype=dtype)
            pads = []
            for n, p in zip(vol.shape[:3], self.padded_shape(bucket)):
                pads = [0, p - n] + pads  # F.pad lists the last axis first
            self._staged = torch.nn.functional.pad(vol, [0, 0] + pads)
            self._staged_key = key
        return self._staged
