"""Image residency queues (as `multiplanarunet_tpu/image/queue/
queues.py`): `BaseQueue`, the API over an ImagePairLoader dataset, and
`EagerQueue`, which loads every image (and its sampler) up front and keeps
it resident. The JAX package's `LazyQueue` and `LimitationQueue` (bounded
host memory with a loading thread pool) are not ported yet."""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np

from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger


class BaseQueue:
    """The queue API over an ImagePairLoader dataset."""

    def __init__(self, dataset, logger=None, **kwargs):
        self.dataset = dataset
        self.logger = logger or ScreenLogger()

    @property
    def all_loaded(self):
        return self.dataset.n_loaded == len(self.dataset)

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        for i in range(len(self.dataset.images)):
            yield self.dataset.images[i]

    def __getitem__(self, idx):
        return self.dataset.images[idx]

    def _random_image(self):
        return self.dataset.images[np.random.randint(len(self.dataset))]

    def get_image_iterator(self, max_load=None):
        inds = np.arange(len(self))
        if max_load and max_load < len(self):
            inds = np.random.choice(inds, max_load, replace=False)
        for i in inds:
            yield self.dataset.images[i]


class EagerQueue(BaseQueue):
    """All images loaded at construction and kept resident."""

    def __init__(self, dataset, logger=None, **kwargs):
        super().__init__(dataset, logger)
        self.logger(f"'Eager' queue created for dataset: {self.dataset}")
        self.logger(f"Preloading all {len(dataset)} images now... (eager)")
        self.dataset.load()

    @staticmethod
    def _ensure_loaded(image):
        if not image.is_loaded:
            raise RuntimeError(
                f"Image '{image.identifier}' was unloaded behind an "
                f"EagerQueue's back; eager datasets must stay resident.")
        return image

    def __iter__(self):
        for i in range(len(self.dataset.images)):
            with self.get_image_by_idx(i) as image:
                yield image

    @contextmanager
    def get_random_image(self):
        yield self._ensure_loaded(self._random_image())

    @contextmanager
    def get_image_by_idx(self, image_idx):
        yield self._ensure_loaded(self.dataset.images[image_idx])

    @contextmanager
    def get_image_by_id(self, image_id):
        yield self._ensure_loaded(self.dataset.id_to_image[image_id])
