"""ImagePairLoader: a dataset = folder of image/label NIfTI pairs.

Port of `multiplanarunet_tpu/image/image_pair_loader.py`: glob of
`*.nii*` under base_dir/img_subdir with a LIST_OF_FILES.txt fallback,
label paths mirrored by subdir substitution, add_image(s) merging, bulk
scaler/bg setup, maximum real-dim query."""

from __future__ import annotations

import glob
from pathlib import Path

import numpy as np

from multiplanarunet_tpu_torch.image.image_pair import ImagePair
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.ops.geometry import get_maximum_real_dim


class ImagePairLoader:
    """A collection of ImagePairs loaded from a dataset directory."""

    def __init__(self, base_dir="./", img_subdir="images",
                 label_subdir="labels", logger=None, sample_weight=1.0,
                 bg_class=0, predict_mode=False, initialize_empty=False,
                 no_log=False, identifier=None, **kwargs):
        self.logger = logger or ScreenLogger()
        self.data_dir = Path(base_dir).absolute()
        self.images_path = self.data_dir / img_subdir
        self.identifier = identifier or self.data_dir.name
        self.queue = None  # may be set by queue wrappers

        self.predict_mode = predict_mode or not label_subdir
        self.labels_path = None if self.predict_mode else self.data_dir / label_subdir

        self.images = []
        self.image_paths = []
        self.label_paths = None
        if not initialize_empty:
            self.image_paths = self._find_image_paths(img_subdir)
            if not self.image_paths:
                raise OSError(f"No image files found at {self.images_path}.")
            if not self.predict_mode:
                self.label_paths = self._mirror_label_paths(img_subdir, label_subdir)
            self.images = self._build_image_objects(sample_weight, bg_class)

        self._id_to_image = self.get_id_to_images_dict()
        if not no_log:
            self._log()

    # ------------------------------------------------------------- protocol
    def __getitem__(self, item):
        return self.images[item]

    def __iter__(self):
        yield from self.images

    def __len__(self):
        return len(self.images)

    def __str__(self):
        return (f"ImagePairLoader(id={self.identifier}, images={len(self)}, "
                f"data_dir={self.data_dir})")

    __repr__ = __str__

    def _log(self):
        self.logger(str(self))
        self.logger(f"--- Image subdir: {self.images_path}\n"
                    f"--- Label subdir: {self.labels_path}")

    # ------------------------------------------------------------ path logic
    def _find_image_paths(self, img_subdir):
        paths = sorted(glob.glob(str(self.images_path / "*.nii*")))
        if paths:
            return [Path(p) for p in paths]
        # Fall back to a LIST_OF_FILES.txt of absolute paths (cv_split format)
        list_file = self.images_path / "LIST_OF_FILES.txt"
        if not list_file.exists():
            return []
        lines = [l.strip() for l in list_file.read_text().splitlines()]
        return [Path(l) for l in lines if l]

    def _mirror_label_paths(self, img_subdir, label_subdir):
        for p in self.image_paths:
            if img_subdir not in str(p):
                raise ValueError(
                    f"Image path '{p}' does not contain the img_subdir "
                    f"'{img_subdir}' — cannot derive its label path."
                )
        return [p.parent.parent / label_subdir / p.name for p in self.image_paths]

    def _build_image_objects(self, sample_weight, bg_class):
        label_paths = self.label_paths or [None] * len(self.image_paths)
        images = []
        for img_path, lab_path in zip(self.image_paths, label_paths):
            images.append(
                ImagePair(img_path, lab_path, sample_weight=sample_weight,
                          bg_class=bg_class, logger=self.logger)
            )
        if not self.predict_mode and not self.label_paths:
            raise OSError(f"No label files found at {self.labels_path}.")
        return images

    # --------------------------------------------------------------- queries
    @property
    def id_to_image(self):
        return self._id_to_image

    def get_id_to_images_dict(self):
        return {image.identifier: image for image in self}

    def get_by_id(self, image_id):
        return self._id_to_image[image_id]

    @property
    def n_loaded(self):
        return sum(image.is_loaded for image in self.images)

    def get_random(self, N=1, unique=False):
        """Yield N randomly drawn ImagePairs (without replacement if unique)."""
        chosen = []
        while len(chosen) < N:
            image = self.images[np.random.randint(len(self))]
            if unique and image in chosen:
                continue
            chosen.append(image)
            yield image

    def get_maximum_real_dim(self):
        """Longest physical axis span (mm) across all images."""
        return float(np.max([get_maximum_real_dim(f.image_obj) for f in self]))

    # ------------------------------------------------------------- mutation
    def load(self):
        for image in self:
            image.load()

    def unload(self):
        for image in self:
            image.unload()

    def add_image(self, image_pair):
        self.images.append(image_pair)
        self._id_to_image = self.get_id_to_images_dict()

    def add_images(self, image_pair_loader):
        try:
            self.images += image_pair_loader.images
        except AttributeError:
            self.images += list(image_pair_loader)
        self._id_to_image = self.get_id_to_images_dict()
        return self

    def set_scaler_and_bg_values(self, bg_value, scaler, compute_now=False):
        """Configure bg value + scaler (and thereby sampler) on every image."""
        for image in self._id_to_image.values():
            image.set_bg_value(bg_value, compute_now=compute_now)
            image.set_scaler(scaler, compute_now=compute_now)
            image.log_image()
