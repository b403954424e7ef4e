"""The port's image residency queues, as the JAX package's queue tests
hold its own (eager and lazy queues, a LimitationQueue cycling its images
under a bound, get_data_queues' fallback to eager, a LoadingPool that
replaces an image it cannot load), plus: an image the queues unload keeps
no staged tensors. Every test that waits on loader threads runs under a
deadline, so none can hang."""
import functools
import gzip
import shutil
import threading

import numpy as np
import pytest
import torch

from multiplanarunet_tpu.bin.toy_data import create_dataset
from multiplanarunet_tpu_torch.image.image_pair_loader import ImagePairLoader
from multiplanarunet_tpu_torch.image.queue.queues import (
    EagerQueue,
    LazyQueue,
    LimitationQueue,
    LoadingPool,
    get_data_queues,
    validate_queue_type,
)
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from tests.torch_projects import torch_threads  # noqa: F401

DEADLINE_S = 120


def within_deadline(fn):
    """Run the test body in a daemon thread; fail (instead of hanging) when
    it has not returned after DEADLINE_S seconds."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        box = {}

        def run():
            try:
                box["out"] = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                box["err"] = e
        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(DEADLINE_S)
        if t.is_alive():
            pytest.fail(f"{fn.__name__} did not finish in {DEADLINE_S} s")
        if "err" in box:
            raise box["err"]
        return box.get("out")
    return wrapper


@pytest.fixture(scope="module")
def toy_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("queue_toy")
    rng = np.random.RandomState(1)
    create_dataset(root / "train", 4, 32, 1, rng, "train")
    create_dataset(root / "val", 2, 32, 1, rng, "val")
    return root


def _loader(path, bg_value="1pct", scaler="RobustScaler"):
    loader = ImagePairLoader(base_dir=path, logger=ScreenLogger(False),
                             no_log=True)
    loader.set_scaler_and_bg_values(bg_value=bg_value, scaler=scaler,
                                    compute_now=False)
    return loader


def test_eager_and_lazy_queues(toy_dataset):
    loader = _loader(toy_dataset / "val")
    q = EagerQueue(loader, logger=ScreenLogger(False))
    assert loader.n_loaded == len(loader)
    with q.get_random_image() as img:
        assert img.is_loaded
    loader.unload()

    lq = LazyQueue(loader, logger=ScreenLogger(False))
    assert loader.n_loaded == 0
    with lq.get_image_by_idx(0) as img:
        assert img.is_loaded
    assert loader.n_loaded == 0  # unloaded on exit
    with lq.get_image_by_id(loader.images[1].identifier) as img:
        assert img.is_loaded and img is loader.images[1]
    with lq.get_random_image() as img:
        assert img.is_loaded
    assert loader.n_loaded == 0


@within_deadline
def test_limitation_queue_cycles(toy_dataset):
    """max_loaded 2 of 4 images, each swapped out after 3 accesses: every
    image comes round, and no access sees more than 2 images loaded (an
    image is unloaded before its replacement is requested)."""
    loader = _loader(toy_dataset / "train")
    q = LimitationQueue(loader, max_loaded=2, num_access_before_reload=3,
                        preload_now=True, await_preload=True,
                        n_load_jobs=2, logger=ScreenLogger(False))
    assert loader.n_loaded == 2
    seen, loaded = set(), []
    for _ in range(30):
        with q.get_random_image() as img:
            assert img.is_loaded
            seen.add(img.identifier)
            loaded.append(loader.n_loaded)
    q.loading_pool.join()
    assert len(seen) >= 3  # rotation happened
    assert max(loaded) <= 2 and loader.n_loaded <= 2
    with pytest.raises(NotImplementedError):
        q.get_image_by_idx(0)
    q.loading_pool.de_register_dataset(loader.identifier)


@within_deadline
def test_get_data_queues_fallback(toy_dataset):
    train = _loader(toy_dataset / "train")
    val = _loader(toy_dataset / "val")
    log = ScreenLogger(False)
    tq, vq = get_data_queues(train, val, "limitation", "eager",
                             max_loaded=None, num_access_before_reload=50,
                             logger=log)
    # max_loaded=None -> limitation falls back to eager
    assert isinstance(tq, EagerQueue)
    assert isinstance(vq, EagerQueue)
    assert validate_queue_type(LimitationQueue, train, 4, log) is EagerQueue
    assert validate_queue_type(LazyQueue, train, 2, log) is LazyQueue
    train.unload(), val.unload()
    # a bound below the dataset: a LimitationQueue over its own pool
    tq, vq = get_data_queues(train, val, "limitation", "eager",
                             max_loaded=2, num_access_before_reload=5,
                             logger=log)
    assert isinstance(tq, LimitationQueue) and isinstance(vq, EagerQueue)
    assert tq.max_loaded == 2 and tq.num_access_before_reload == 5
    assert train.n_loaded == 2 and val.n_loaded == len(val)
    tq.loading_pool.de_register_dataset(train.identifier)


@within_deadline
def test_loading_pool_recovers_from_corrupt_file(toy_dataset, tmp_path):
    """An image whose data cannot be read (a valid header, a truncated
    payload) goes to the error callback and is replaced, so accesses keep
    being served."""
    root = tmp_path / "corrupt_ds"
    shutil.copytree(toy_dataset / "train", root)
    victim = sorted((root / "images").glob("*.nii.gz"))[0]
    payload = gzip.decompress(victim.read_bytes())
    victim.write_bytes(gzip.compress(payload[:400]))  # header ok, data cut
    loader = _loader(root, bg_value=1.0, scaler="StandardScaler")
    q = LimitationQueue(loader, max_loaded=2, num_access_before_reload=3,
                        preload_now=True, await_preload=True,
                        n_load_jobs=2, logger=ScreenLogger(False))
    served = set()
    for _ in range(10):
        with q.get_random_image() as img:
            assert img.is_loaded
            served.add(img.identifier)
    assert victim.name.split(".")[0] not in served
    q.loading_pool.join()
    q.loading_pool.de_register_dataset(loader.identifier)


def test_loading_pool_rejects_unregistered_datasets(toy_dataset):
    pool = LoadingPool(n_threads=1, logger=ScreenLogger(False))
    loader = _loader(toy_dataset / "val")
    with pytest.raises(RuntimeError, match="not registered"):
        pool.add_image_to_load_queue(loader.images[0], loader.identifier)
    pool.register_dataset(loader.identifier, lambda im: None,
                          lambda im: None)
    with pytest.raises(RuntimeWarning, match="already registered"):
        pool.register_dataset(loader.identifier, lambda im: None,
                              lambda im: None)
    pool.de_register_dataset(loader.identifier)


@within_deadline
def test_unloaded_images_keep_no_staged_tensors(toy_dataset):
    """An image staged on the (CPU) device by the per-image sampler drops
    its staged volume, labels and host caches when its queue unloads it:
    a LimitationQueue after its accesses, a LazyQueue on leaving the
    context."""
    loader = _loader(toy_dataset / "train")
    q = LimitationQueue(loader, max_loaded=2, num_access_before_reload=1,
                        n_load_jobs=1, logger=ScreenLogger(False))
    samplers = []
    for _ in range(8):
        with q.get_random_image() as img:
            s = img.interpolator
            s.device_volume_unpacked("cpu", dtype=torch.float32)
            s.device_labels("cpu")
            samplers.append((img, s))
    q.loading_pool.join()
    unloaded = [(img, s) for img, s in samplers if not img.is_loaded]
    assert unloaded
    for img, s in unloaded:
        assert s._staged is None and s._labels_staged is None
        assert s._scaled_cache is None and s._codes is None
    q.loading_pool.de_register_dataset(loader.identifier)

    lazy = LazyQueue(_loader(toy_dataset / "val"), logger=ScreenLogger(False))
    with lazy.get_image_by_idx(0) as img:
        s = img.interpolator
        s.device_labels("cpu")
        assert s._labels_staged is not None
    assert not img.is_loaded and s._labels_staged is None
