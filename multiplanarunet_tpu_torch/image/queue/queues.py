"""Image residency queues: eager, lazy and bounded-memory (limitation).

Port of `multiplanarunet_tpu/image/queue/queues.py`, with the same three
policies: load everything up front (`EagerQueue`: train/val sets that
fit), load just in time inside a context (`LazyQueue`), or keep at most
`max_loaded` images resident, each serving `num_access_before_reload`
accesses before it is unloaded and a random unloaded image is loaded in
its place by a background thread pool (`LimitationQueue` over a
`LoadingPool`). Unloading an ImagePair also drops its staged device
tensors (`VolumeSampler.unload_device`), so the device working set of the
per-image sampler follows the host working set; the pooled sampler keeps
`max_loaded` slots (`sequences/multi_planar.py`).

`get_data_queues` builds a training run's (train, val) queues, falling
back to eager where the limitation bound covers the whole dataset
(`validate_queue_type`).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from queue import Empty, Queue

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


class LazyQueue(BaseQueue):
    """Loads each image only inside the access context; unloads on exit."""

    def __init__(self, dataset, logger=None, **kwargs):
        super().__init__(dataset, logger)
        self.logger(f"'Lazy' queue created for dataset: {self.dataset}")
        self.logger("Images load just-in-time and unload after use.")

    @contextmanager
    def _ctx(self, image):
        with image.loaded_in_context():
            yield image

    def get_random_image(self):
        return self._ctx(self._random_image())

    def get_image_by_idx(self, image_idx):
        return self._ctx(self.dataset.images[image_idx])

    def get_image_by_id(self, image_id):
        return self._ctx(self.dataset.id_to_image[image_id])


class LoadingPool:
    """Thread pool that loads ImagePairs in the background.

    Datasets register (loaded, error) callbacks; worker threads pull
    (image, dataset_id) jobs, call image.load() (host work only: NIfTI
    decode, bg value, scaler fit, sampler geometry) and dispatch to the
    owning dataset's callback. A failed load goes to the error callback,
    so the queue can request a replacement."""

    def __init__(self, n_threads=5, max_queue_size=50, logger=None):
        self.logger = logger or ScreenLogger()
        self._jobs = Queue(maxsize=max_queue_size or 50)
        self._pending = 0
        self._pending_cv = threading.Condition()
        self.thread_lock = threading.Lock()
        self._registered = {}
        self._threads = []
        for _ in range(n_threads):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self):
        while True:
            image, dataset_id = self._jobs.get()
            callbacks = self._registered.get(dataset_id)
            try:
                image.load()
                if callbacks:
                    callbacks[0](image)
            except Exception as e:  # noqa: BLE001 - report and replace
                with self.thread_lock:
                    self.logger.warn(
                        f"[LoadingPool] could not load '{image}': {e}")
                if callbacks:
                    callbacks[1](image)
            finally:
                self._jobs.task_done()
                with self._pending_cv:
                    self._pending -= 1
                    self._pending_cv.notify_all()

    def qsize(self):
        return self._jobs.qsize()

    @property
    def maxsize(self):
        return self._jobs.maxsize

    def join(self):
        """Block until every submitted job has fully dispatched."""
        with self._pending_cv:
            self._pending_cv.wait_for(lambda: self._pending == 0)

    def add_image_to_load_queue(self, image_pair, dataset_id):
        if dataset_id not in self._registered:
            raise RuntimeError(
                f"Dataset '{dataset_id}' is not registered with this "
                f"LoadingPool; call register_dataset first.")
        with self._pending_cv:
            self._pending += 1
        self._jobs.put((image_pair, dataset_id))

    def register_dataset(self, dataset_id, load_put_function,
                         error_put_function):
        with self.thread_lock:
            if dataset_id in self._registered:
                raise RuntimeWarning(
                    f"Dataset '{dataset_id}' already registered.")
            self._registered[dataset_id] = (load_put_function,
                                            error_put_function)

    def de_register_dataset(self, dataset_id):
        with self.thread_lock:
            self._registered.pop(dataset_id, None)


class LimitationQueue(BaseQueue):
    """Bounded-memory training queue.

    At most `max_loaded` images resident; each yields
    `num_access_before_reload` accesses, then unloads while a background
    thread loads a random non-resident image (each such reload is logged,
    to the log file only). Initial access counters start at random offsets
    so reloads decorrelate across the run."""

    def __init__(self, dataset, max_loaded=25, num_access_before_reload=50,
                 preload_now=True, await_preload=True, loading_pool=None,
                 n_load_jobs=5, logger=None, **kwargs):
        super().__init__(dataset, logger)
        self.max_loaded = min(max_loaded or len(dataset), len(dataset))
        self.num_access_before_reload = num_access_before_reload or 50

        self._loaded = Queue(maxsize=self.max_loaded)
        self._not_loaded = Queue(maxsize=len(dataset))
        order = np.random.permutation(len(dataset))
        for i in order:
            self._not_loaded.put(self.dataset.images[i])

        self.loading_pool = loading_pool or LoadingPool(n_threads=n_load_jobs)
        self.loading_pool.register_dataset(
            dataset_id=self.dataset.identifier,
            load_put_function=self._on_loaded,
            error_put_function=self._on_load_error)

        # The first max_loaded images get random starting counters
        self._n_initial_offsets = self.max_loaded
        self._max_offset = max(1, int(self.num_access_before_reload * 0.75))

        self.logger(
            f"'Limitation' queue created:\n"
            f"  Dataset:      {self.dataset}\n"
            f"  Max loaded:   {self.max_loaded}\n"
            f"  Reload limit: {self.num_access_before_reload}")
        if preload_now:
            self.preload(await_preload)

    def preload(self, await_preload=True):
        if self.dataset.n_loaded != 0 or self._loaded.qsize() != 0:
            raise RuntimeError(
                f"Dataset {self.dataset.identifier} appears already loaded; "
                f"hand an unloaded dataset to LimitationQueue and call "
                f"preload only once.")
        self.logger(
            f"Queueing {self.max_loaded} loads from {self.dataset.identifier}")
        self._request_loads(self.max_loaded)
        if await_preload:
            self.logger("... awaiting preload")
            self.loading_pool.join()
            self.logger("Preload complete.")

    # ------------------------------------------------------------ callbacks
    def _on_loaded(self, image_pair):
        if self._n_initial_offsets > 0:
            self._n_initial_offsets -= 1
            offset = np.random.randint(0, self._max_offset)
        else:
            offset = 0
        self._loaded.put((image_pair, offset))

    def _on_load_error(self, image_pair):
        self.logger.warn(f"Load error on image {image_pair}; replacing.")
        self._not_loaded.put(image_pair)
        self._request_loads(1)

    def _request_loads(self, num):
        for _ in range(num):
            image = self._not_loaded.get_nowait()
            self.loading_pool.add_image_to_load_queue(
                image, self.dataset.identifier)

    # --------------------------------------------------------------- access
    def _warn_if_starved(self, min_fraction=0.10):
        qsize = self._loaded.qsize()
        if qsize == 0:
            self.logger.warn(
                f"Loaded queue for {self.dataset.identifier} is empty; "
                f"data loading may be a bottleneck.")
        elif qsize <= self.max_loaded * min_fraction:
            self.logger.warn(
                f"Dataset {self.dataset.identifier}: loaded queue low "
                f"(qsize={qsize}, max={self.max_loaded})")

    @contextmanager
    def get_random_image(self):
        self._warn_if_starved()
        timeout_s = 15
        try:
            image_pair, n_accesses = self._loaded.get(timeout=timeout_s)
        except Empty as e:
            raise Empty(
                f"No loaded image available from {self.dataset.identifier} "
                f"within {timeout_s}s; increase load threads / max_loaded / "
                f"access threshold.") from e
        try:
            yield image_pair
        finally:
            self._release(image_pair, n_accesses)

    def _release(self, image_pair, n_accesses):
        if n_accesses >= self.num_access_before_reload:
            image_pair.unload()
            self.logger(f"Reload: unloaded {image_pair.identifier} after "
                        f"{n_accesses} accesses; loading a random unloaded "
                        f"image of {self.dataset.identifier}", no_print=True)
            self._not_loaded.put(image_pair)
            self._request_loads(1)
        else:
            self._loaded.put((image_pair, n_accesses + 1))

    def get_image_by_id(self, image_id):
        raise NotImplementedError(
            "LimitationQueue serves random images only; use Eager/LazyQueue "
            "for id-based access.")

    def get_image_by_idx(self, image_idx):
        raise NotImplementedError(
            "LimitationQueue serves random images only; use Eager/LazyQueue "
            "for idx-based access.")


def validate_queue_type(queue_cls, dataset, max_loaded, logger):
    """Fall back to EagerQueue when limitation bounds exceed the dataset."""
    if queue_cls is LimitationQueue and (
            max_loaded is None or len(dataset) <= max_loaded):
        logger.warn(
            f"Using 'Eager' queue for dataset {dataset}: max_loaded="
            f"{max_loaded} covers all {len(dataset)} images.")
        return EagerQueue
    return queue_cls


def get_data_queues(train_dataset, val_dataset, train_queue_type,
                    val_queue_type, max_loaded, num_access_before_reload,
                    logger):
    """Build (train_queue, val_queue) per config, sharing one LoadingPool."""
    mapping = {
        "eager": EagerQueue,
        "lazy": LazyQueue,
        "limitation": LimitationQueue,
    }
    train_cls = validate_queue_type(
        mapping[train_queue_type.lower()], train_dataset, max_loaded, logger)
    val_cls = None
    if val_queue_type and val_dataset:
        val_cls = validate_queue_type(
            mapping[val_queue_type.lower()], val_dataset, max_loaded, logger)

    loading_pool = None
    if LimitationQueue in (train_cls, val_cls):
        loading_pool = LoadingPool(
            n_threads=3, max_queue_size=max_loaded or 50, logger=logger)

    train_queue = train_cls(
        dataset=train_dataset,
        max_loaded=max_loaded,
        num_access_before_reload=num_access_before_reload,
        preload_now=True,
        await_preload=True,
        loading_pool=loading_pool,
        logger=logger)
    val_queue = None
    if val_cls is not None:
        val_queue = val_cls(
            dataset=val_dataset,
            max_loaded=max_loaded,
            num_access_before_reload=num_access_before_reload,
            preload_now=True,
            await_preload=False,
            loading_pool=loading_pool,
            logger=logger)
    return train_queue, val_queue
