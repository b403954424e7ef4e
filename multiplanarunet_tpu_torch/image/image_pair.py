"""ImagePair: one NIfTI image (+ optional labels) with lazy loading.

Port of `multiplanarunet_tpu/image/image_pair.py`: lazy header-only init,
rank-4 image normalization, scanner-space center/shape from the affine,
per-channel background values including "Npct" percentile strings, a
per-channel scaler, load/unload/loaded_in_context (unload also frees the
volume staged on the device) and read-only core attributes. Built on the
port's NIfTI reader and `VolumeSampler`."""

from __future__ import annotations

from contextlib import contextmanager
from pathlib import Path

import numpy as np

from multiplanarunet_tpu_torch.errors.image_errors import (
    ReadOnlyAttributeError,
)
from multiplanarunet_tpu_torch.image.volume_sampler import VolumeSampler
from multiplanarunet_tpu_torch.io import nifti
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.ops.geometry import (
    get_pix_dim,
    get_real_image_size,
)
from multiplanarunet_tpu_torch.preprocessing.scaling import (
    NoOpScaler,
    get_scaler,
)


class ImagePair:
    """One data point: a .nii(.gz) image and (optionally) its label map."""

    def __init__(self, img_path, labels_path=None, sample_weight=1.0,
                 bg_class=0, logger=None, im_dtype=np.float32,
                 lab_dtype=np.uint8):
        self.predict_mode = not labels_path
        self.logger = logger or ScreenLogger()
        self.im_dtype = im_dtype
        self.lab_dtype = lab_dtype

        self._sample_weight = None
        self.sample_weight = sample_weight

        self.image_path = self._validate_path(img_path)
        self.labels_path = None
        if not self.predict_mode:
            self.labels_path = self._validate_path(labels_path)
        self.identifier = self._resolve_id()

        # Header-only objects; voxel data loads on first access
        self.image_obj = nifti.load(self.image_path)
        self.labels_obj = nifti.load(self.labels_path) if self.labels_path else None

        self._image = None
        self._labels = None
        self._scaler = None
        self._bg_value = None
        self._bg_class = int(bg_class)
        self._interpolator = None

    # ------------------------------------------------------------- identity
    @staticmethod
    def _validate_path(path):
        path = Path(path)
        if path.exists() and path.suffix in (".nii", ".gz", ".mat"):
            return path
        raise FileNotFoundError(f"File '{path}' not found or not .nii/.nii.gz")

    def _resolve_id(self):
        img_id = self.image_path.name.split(".")[0]
        if not self.predict_mode:
            lab_id = self.labels_path.name.split(".")[0]
            if img_id != lab_id:
                raise ValueError(
                    f"Image id '{img_id}' does not match labels id '{lab_id}'"
                )
        return img_id

    def __str__(self):
        return (f"ImagePair(id={self.identifier}, shape={self.shape}, "
                f"loaded={self.is_loaded})")

    __repr__ = __str__

    def log_image(self, print_calling_method=False):
        self.logger(
            f"{self.identifier}\n"
            f"--- loaded:     {self.is_loaded}\n"
            f"--- shape:      {self.shape}\n"
            f"--- bg class    {self._bg_class}\n"
            f"--- bg value    {self._bg_value}\n"
            f"--- scaler      {self._scaler}\n"
            f"--- real shape: {np.round(self.real_shape, 3)}\n"
            f"--- pixdim:     {np.round(get_pix_dim(self.image_obj), 3)}",
            print_calling_method=print_calling_method,
        )

    # ----------------------------------------------------- read-only headers
    @property
    def affine(self):
        return self.image_obj.affine

    @affine.setter
    def affine(self, _):
        raise ReadOnlyAttributeError(
            "The affine cannot be reassigned; create a new ImagePair."
        )

    @property
    def header(self):
        return self.image_obj.header

    @header.setter
    def header(self, _):
        raise ReadOnlyAttributeError(
            "The header cannot be reassigned; create a new ImagePair."
        )

    # ------------------------------------------------------------- voxeldata
    @property
    def image(self):
        """Voxel data, loaded on first access, always rank-4 (X, Y, Z, C)."""
        if self._image is None:
            self._image = self.image_obj.get_fdata(
                caching="unchanged", dtype=self.im_dtype
            )
        if self._image.ndim == 3:
            self._image = self._image[..., None]
        return self._image

    @image.setter
    def image(self, _):
        raise ReadOnlyAttributeError(
            "Image data cannot be reassigned; create a new ImagePair."
        )

    @property
    def labels(self):
        if self._labels is None and self.labels_obj is not None:
            lab = self.labels_obj.get_fdata(caching="unchanged")
            if lab.ndim == 4:
                lab = lab[..., 0]
            self._labels = lab.astype(self.lab_dtype)
        return self._labels

    @labels.setter
    def labels(self, _):
        raise ReadOnlyAttributeError(
            "Label data cannot be reassigned; create a new ImagePair."
        )

    # --------------------------------------------------------------- weights
    @property
    def sample_weight(self):
        return self._sample_weight

    @sample_weight.setter
    def sample_weight(self, weight):
        try:
            weight = float(weight)
        except (TypeError, ValueError):
            raise ValueError(f"Sample weight must be numeric, got {weight!r}")
        if not 0 < weight <= 1:
            raise ValueError("Sample weight must be in (0, 1]")
        self._sample_weight = weight

    # -------------------------------------------------------------- geometry
    @property
    def shape(self):
        """Voxel shape, always rank-4 with a channel axis."""
        s = np.asarray(self.image_obj.shape)
        if len(s) == 3:
            s = np.append(s, 1)
        return s

    @property
    def n_channels(self):
        return int(self.shape[-1])

    @property
    def center(self):
        """Voxel-space center of the image."""
        return (self.shape[:-1] - 1) / 2

    @property
    def real_center(self):
        """Scanner-space position of the voxel-space center."""
        aff = self.affine
        return aff[:3, :3].dot(self.center) + aff[:3, -1]

    @property
    def real_shape(self):
        """Physical extent (mm) of the volume along each axis."""
        return get_real_image_size(self.image_obj)

    # ------------------------------------------------------------- bg values
    @property
    def bg_class(self):
        return self._bg_class

    @bg_class.setter
    def bg_class(self, _):
        raise ReadOnlyAttributeError(
            "The background class cannot be reassigned."
        )

    @property
    def bg_value(self):
        if self._bg_value is None or isinstance(self._bg_value[0], str):
            self.set_bg_value(self._bg_value, compute_now=True)
        return self._bg_value

    @bg_value.setter
    def bg_value(self, _):
        raise ReadOnlyAttributeError("Use set_bg_value() to change bg values.")

    def set_bg_value(self, bg_value, compute_now=False):
        """Set the out-of-volume fill value. Accepts numbers, per-channel
        lists, or "<p>pct" percentile strings (computed from the image data,
        lazily unless compute_now)."""
        bg_value = self._standardize_bg(bg_value)
        if compute_now and isinstance(bg_value[0], str):
            bg_value = self._percentiles(bg_value)
        self._bg_value = bg_value

    def _standardize_bg(self, bg_value):
        if not isinstance(bg_value, (list, tuple, np.ndarray)):
            bg_value = [bg_value]
        vals = [
            v if (v is not None and v is not False) else "1pct"
            for v in bg_value
        ]
        if len(vals) == 1 and self.n_channels != 1:
            vals = vals * self.n_channels
        return vals

    def _percentiles(self, pct_strings):
        out = []
        for c, s in enumerate(pct_strings):
            pct = int(str(s).lower().replace(" ", "").split("pct")[0])
            out.append(float(np.percentile(self.image[..., c], pct)))
        self.logger.warn(
            f"Image {self.identifier}: computed {pct_strings} percentile "
            f"bg value {out}", no_print=True,
        )
        return out

    # ---------------------------------------------------------------- scaler
    @property
    def scaler(self):
        if isinstance(self._scaler, tuple):
            self.set_scaler(*self._scaler, compute_now=True)
        return self._scaler

    @scaler.setter
    def scaler(self, _):
        raise ReadOnlyAttributeError("Use set_scaler() to change the scaler.")

    def set_scaler(self, scaler, ignore_less_eq=None, compute_now=False):
        """Set (and optionally fit now) a per-channel scaler by its sklearn
        name (see `preprocessing.scaling` for the names the port fits)."""
        if compute_now:
            if scaler is None or str(scaler).lower() in ("null", "none"):
                self._scaler = NoOpScaler().fit(self.image)
            else:
                self._scaler = get_scaler(
                    scaler, ignore_less_eq=ignore_less_eq
                ).fit(self.image)
        else:
            self._scaler = (scaler, ignore_less_eq)

    def apply_scaler(self):
        """Apply the fitted scaler to the stored image in place."""
        self._image = self.scaler.transform(self.image)

    # ----------------------------------------------------------- interpolator
    @property
    def interpolator(self):
        if not self._interpolator:
            self.set_interpolator_with_current()
        return self._interpolator

    @interpolator.setter
    def interpolator(self, _):
        raise ReadOnlyAttributeError(
            "Use set_interpolator_with_current() to rebuild the sampler."
        )

    def get_interpolator_with_current(self):
        if not self.bg_value:
            raise RuntimeError(
                "Cannot build a sampler without a bg value; call "
                "set_bg_value first."
            )
        return VolumeSampler(
            self.image, self.affine, bg_value=self.bg_value,
            scaler=self.scaler,
            labels=None if self.predict_mode else self.labels,
            bg_class=self.bg_class)

    def set_interpolator_with_current(self):
        self._interpolator = self.get_interpolator_with_current()

    # ------------------------------------------------------------ load state
    @property
    def is_loaded(self):
        return self._image is not None

    @property
    def estimated_memory(self):
        """Upper-bound bytes to store image + labels in memory."""
        n_vox = int(np.prod(self.shape))
        bytes_im = n_vox * np.dtype(self.im_dtype).itemsize
        bytes_lab = 0 if self.predict_mode else (
            int(np.prod(self.shape[:3])) * np.dtype(self.lab_dtype).itemsize
        )
        return bytes_im + bytes_lab

    def load(self):
        """Force-load image, labels, bg value, scaler and sampler."""
        for attr in ("image", "labels", "bg_value", "scaler", "interpolator"):
            getattr(self, attr)

    @contextmanager
    def loaded_in_context(self):
        """Keep this ImagePair loaded inside the context, unload on exit."""
        try:
            yield self.load()
        finally:
            self.unload()

    def unload(self, unload_scaler=False):
        if self._interpolator is not None:
            self._interpolator.unload_device()
        self._image = None
        self._labels = None
        self._interpolator = None
        if unload_scaler:
            self._scaler = None
