"""The port's pooled training sampler against the JAX package's, on the
same toy NIfTI data (3 images of 32^3) and numpy seeds: the pool gathers
(linear within 1e-5, nearest equal on >= 0.9999 of points), the
DeviceVolumePool's shapes, slots, LRU order and per-slot params, pooled
batches (images within 1e-5 of the largest scaled intensity, labels
equal on >= 0.9999 of pixels, weights equal, the same chosen candidates;
with Elastic2D the same weights and host draws), the host walk against JAX's in-graph walk, the choice
between the pooled and the per-image path, a batch-size change, the
pooled path over a LimitationQueue, and a bare ImagePairLoader in
get_sequence."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multiplanarunet_tpu.bin.toy_data import create_dataset
from multiplanarunet_tpu.image import ImagePairLoader as JLoader
from multiplanarunet_tpu.image.queue import EagerQueue as JEager
from multiplanarunet_tpu.image.queue import LimitationQueue as JLimitation
from multiplanarunet_tpu.logging import ScreenLogger as JScreen
from multiplanarunet_tpu.ops import geometry as jgeo
from multiplanarunet_tpu.ops import interp as jinterp
from multiplanarunet_tpu.parallel.volume_pool import (
    DeviceVolumePool as JPool,
)
from multiplanarunet_tpu.sequences import get_sequence as j_get_sequence
from multiplanarunet_tpu.sequences.multi_planar import _walk_select
from multiplanarunet_tpu_torch.image.image_pair_loader import ImagePairLoader
from multiplanarunet_tpu_torch.image.queue.queues import (
    EagerQueue,
    LimitationQueue,
)
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.ops import interp as tinterp
from multiplanarunet_tpu_torch.parallel.volume_pool import DeviceVolumePool
from multiplanarunet_tpu_torch.sequences import get_sequence
from multiplanarunet_tpu_torch.sequences.multi_planar import MAX_TRIES
from tests.torch_projects import torch_threads  # noqa: F401


VIEWS = jgeo.sample_random_views_with_angle_restriction(
    3, 60, rng=np.random.RandomState(2))
ELASTIC = [{"cls_name": "Elastic2D",
            "kwargs": {"alpha": [0, 100], "sigma": [10, 12],
                       "apply_prob": 0.5, "seed": 5}}]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("pooled_toy")
    create_dataset(root / "train", 3, 32, 1, np.random.RandomState(7),
                   "train", pixdim=(1.0, 1.1, 0.9))
    return root / "train"


def _loaders(data_dir):
    out = {}
    for name, loader_cls, log in (("jax", JLoader, JScreen(False)),
                                  ("port", ImagePairLoader,
                                   ScreenLogger(False))):
        loader = loader_cls(base_dir=data_dir, logger=log, no_log=True)
        loader.set_scaler_and_bg_values(bg_value="1pct",
                                        scaler="RobustScaler")
        out[name] = loader
    return out


@pytest.fixture(scope="module")
def queues(data_dir):
    loaders = _loaders(data_dir)
    return {"jax": JEager(loaders["jax"], logger=JScreen(False)),
            "port": EagerQueue(loaders["port"], logger=ScreenLogger(False))}


def _sequences(queues, **over):
    kw = dict(intrp_style="iso_live", views=VIEWS, dim=32, batch_size=6,
              n_classes=4, real_space_span=34.0, noise_sd=0.1,
              fg_batch_fraction=0.5, no_log=True)
    kw.update(over)
    jseq = j_get_sequence(queues["jax"], logger=JScreen(False), **kw)
    tseq = get_sequence(queues["port"], logger=ScreenLogger(False),
                        device="cpu", **kw)
    for seq in (jseq, tseq):
        seq.seed = lambda: None  # the test seeds numpy itself
    return jseq, tseq


def _assert_images_close(got, want):
    """Within 1e-5 of the batch's largest scaled intensity: the sklearn
    and numpy RobustScaler fits agree to float32 rounding (a few 1e-6
    relative), and an interpolated value near 0 between large corners
    keeps their absolute error."""
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def _record_choices(seq):
    """Record select_candidate's choices (the phase-2 rows of the host
    walk; the other rows take their first candidate)."""
    picks = []
    select = seq.select_candidate

    def recording(*a):
        out = select(*a)
        picks.append(out[0])
        return out
    seq.select_candidate = recording
    return picks


def _random_pool(rng, C):
    extents = [(20, 22, 18), (24, 17, 21), (16, 24, 24)]
    pool = np.zeros((3, 24, 24, 24, C), np.float32)
    for s, (x, y, z) in enumerate(extents):
        pool[s, :x, :y, :z] = rng.rand(x, y, z, C)
    return pool, np.asarray(extents, np.int32)


@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_pool_gathers_match_jax(method):
    """sample_plane_batch_pool and grid_gather_pool on a random 3-slot
    pool of different extents, with per-sample geometry and fills."""
    rng = np.random.RandomState(0)
    C = 2 if method == "linear" else 1
    pool, extents = _random_pool(rng, C)
    if method == "nearest":
        pool = np.floor(pool * 5)
    B = 7
    slots = rng.randint(0, 3, B).astype(np.int32)
    spacings = rng.uniform(0.8, 1.2, (B, 3)).astype(np.float32)
    origins = (-(extents[slots] - 1) / 2 * spacings).astype(np.float32)
    rots = np.stack([jgeo.rotation_matrix(rng.randn(3), rng.uniform(0, 30))
                     for _ in range(B)]).astype(np.float32)
    bases = jgeo.plane_basis_batch(VIEWS[rng.randint(0, 3, B)], noise_sd=0.1)
    offsets = rng.uniform(-6, 6, B).astype(np.float32)
    fills = rng.randn(B, C).astype(np.float32)
    if method == "nearest":
        fills = np.floor(np.abs(fills) * 3)
    valid = extents[slots]
    want = np.asarray(jinterp.sample_plane_batch_pool(
        jnp.asarray(pool), jnp.asarray(slots), jnp.asarray(origins),
        jnp.asarray(spacings), jnp.asarray(rots), jnp.asarray(bases),
        jnp.asarray(offsets), 26.0, 16, jnp.asarray(fills), method=method,
        valid_shapes=jnp.asarray(valid)))
    tpool = torch.from_numpy(pool)
    got = tinterp.sample_plane_batch_pool(
        tpool, slots, origins, spacings, rots, bases, offsets, 26.0, 16,
        fills, method=method, valid_shapes=valid).numpy()
    assert got.shape == want.shape == (B, 16, 16, C)
    # points of B samples inside and outside their slot's extent
    pts = rng.uniform(-14, 14, (B, 5, 9, 3)).astype(np.float32)
    want_g = np.stack([np.asarray(jinterp.grid_gather_pool(
        jnp.asarray(pool), jnp.asarray(slots[b]), origins[b], spacings[b],
        jnp.asarray(pts[b]), method=method, fill=fills[b],
        valid_shape=jnp.asarray(valid[b]))) for b in range(B)])
    got_g = tinterp.grid_gather_pool(
        tpool, slots, origins, spacings, torch.from_numpy(pts),
        method=method, fills=fills, valid_shapes=valid).numpy()
    if method == "linear":
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(got_g, want_g, atol=1e-5)
    else:
        assert (got == want).mean() >= 0.9999
        assert (got_g == want_g).mean() >= 0.9999
    assert (want == fills[:, None, None]).any()  # some points fell outside


def test_volume_pool_matches_jax(queues):
    """Fed the same images in the same order, both pools pick the same
    slots, evict in the same LRU order and hold the same parameters and
    contents."""
    jimgs = queues["jax"].dataset.images
    timgs = queues["port"].dataset.images
    shape = DeviceVolumePool.shape_for(timgs)
    assert shape == JPool.shape_for(jimgs) == (32, 32, 32)
    assert DeviceVolumePool.shape_for(timgs, bucket=24) == (48, 48, 48)
    jpool = JPool(shape, 1, 2, with_labels=True)
    tpool = DeviceVolumePool(shape, 1, 2, "cpu")
    for i in (0, 1, 0, 2, 1, 2, 0, 0, 1):
        assert tpool.ensure(timgs[i]) == jpool.ensure(jimgs[i]), i
        assert tpool._order == jpool._order
    tpool.release(timgs[1].identifier)
    jpool.release(jimgs[1].identifier)
    assert tpool._order == jpool._order
    assert tpool.ensure(timgs[2]) == jpool.ensure(jimgs[2])
    slots = np.array([1, 0, 1])
    tp, jp = tpool.params_for(slots), jpool.params_for(slots)
    assert sorted(tp) == sorted(jp)
    for key in tp:
        np.testing.assert_allclose(tp[key], jp[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(tpool.volumes.numpy(),
                               np.asarray(jpool.volumes), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tpool.labels.numpy(),
                                  np.asarray(jpool.labels))
    assert tpool.labels.dtype == torch.uint8
    assert tpool.nbytes == 2 * 32 ** 3 * (1 * 4 + 1)


@pytest.mark.parametrize("fraction,force", [(0.5, "auto"), (1.0, True)])
def test_pooled_batches_match_jax(queues, fraction, force):
    """3 consecutive batches under one seed against the JAX package's
    default pooled path and its host walk (disable_fused_finish), which
    records its choices."""
    kw = dict(fg_batch_fraction=fraction, force_all_fg=force)
    jseq, tseq = _sequences(queues, **kw)
    jwalk, _ = _sequences(queues, **kw)
    jwalk.disable_fused_finish = True
    picks = {"jax": _record_choices(jwalk), "port": _record_choices(tseq)}
    batches = {}
    for name, seq in (("jax", jseq), ("walk", jwalk), ("port", tseq)):
        np.random.seed(21)
        batches[name] = [seq[i] for i in range(3)]
    assert tseq.use_pool and tseq._pool is not None
    for i, (tX, ty, tw) in enumerate(batches["port"]):
        assert ty.dtype == torch.int32 and tX.shape == (6, 32, 32, 1)
        for ref in ("jax", "walk"):
            jX, jy, jw = batches[ref][i]
            assert ty.shape == tuple(jy.shape)
            _assert_images_close(tX.numpy(), jX)
            equal = (ty.numpy() == np.asarray(jy)).mean()
            assert equal >= 0.9999, (ref, i, equal)
            np.testing.assert_array_equal(tw, jw)
    assert picks["port"] == picks["jax"]
    assert any(p > 0 for p in picks["port"])  # retries were exercised


def test_pooled_elastic_weights_and_draws_match_jax(queues):
    """With Elastic2D (seeded), the augmented samples' weights equal the
    JAX package's on both its paths, the augmenter's host draws leave its
    RandomState where the JAX host walk leaves it, and the deformed planes
    are the JAX package's: the same batch keys give the same noise fields,
    so the images agree as the unaugmented batches do (within 1e-5 of the
    batch's largest intensity) and the labels on >= 0.999 of pixels (the
    2D warp's tolerance on equal fields, tests/test_torch_sampler.py)."""
    jseq, tseq = _sequences(queues, augmenters=ELASTIC)
    jwalk, _ = _sequences(queues, augmenters=ELASTIC)
    jwalk.disable_fused_finish = True
    batches = {}
    for name, seq in (("jax", jseq), ("walk", jwalk), ("port", tseq)):
        np.random.seed(4)
        batches[name] = [seq[i] for i in range(3)]
    weights = {k: [b[2] for b in v] for k, v in batches.items()}
    for ref in ("jax", "walk"):
        for got, want in zip(weights["port"], weights[ref]):
            np.testing.assert_array_equal(got, want)
        for (tX, ty, _), (jX, jy, _) in zip(batches["port"], batches[ref]):
            _assert_images_close(tX.numpy(), jX)
            equal = (ty.numpy() == np.asarray(jy)).mean()
            assert equal >= 0.999, (ref, equal)
    assert any((w != 1.0).any() for w in weights["port"])
    state = lambda s: s.list_of_augmenters[0]._rng.randint(1 << 30)  # noqa
    assert state(tseq) == state(jwalk)


def test_host_walk_matches_jax_walk_select(queues):
    """walk_candidates against the JAX package's in-graph walk on random
    presence patterns, quota settings and phase-2 row subsets."""
    rng = np.random.RandomState(0)
    K = MAX_TRIES
    for trial in range(20):
        B = int(rng.choice([3, 4, 8, 16]))
        n_classes = int(rng.choice([2, 3, 4, 7]))
        force = bool(rng.randint(2))
        frac = float(rng.choice([0.0, 0.25, 0.5, 1.0]))
        seq = get_sequence(queues["port"], intrp_style="iso_live",
                           views=VIEWS, dim=32, batch_size=B,
                           n_classes=n_classes, real_space_span=34.0,
                           fg_batch_fraction=frac, force_all_fg=force,
                           no_log=True, logger=ScreenLogger(False),
                           device="cpu")
        pres = rng.rand(B, K, n_classes) < rng.uniform(0.05, 0.5)
        pres[..., 0] = True
        pres0 = pres[:, 0]
        fg = pres0[:, seq.fg_classes]
        S = np.nonzero(~fg.all(1) if seq.force_all_fg else ~fg.any(1))[0]
        s_pos = np.full(B, -1, np.int64)
        s_pos[S] = np.arange(len(S))
        pres_rest = pres[S, 1:] if len(S) else None
        got = seq.walk_candidates(pres0, pres_rest, s_pos)
        want = np.asarray(_walk_select(
            jnp.asarray(pres0),
            jnp.asarray(pres_rest if len(S)
                        else np.zeros((1, K - 1, n_classes), bool)),
            jnp.asarray(s_pos, jnp.int32),
            tuple(int(c) for c in seq.fg_classes), int(seq.n_fg_slices),
            bool(seq.force_all_fg)))
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")


@pytest.mark.parametrize("max_loaded,batch_size,pooled",
                         [(2, 4, False), (2, 2, True), (None, 4, True)])
def test_path_choice_matches_jax(data_dir, max_loaded, batch_size, pooled):
    """Pooled unless the pool (a LimitationQueue's max_loaded slots, or
    the dataset) is smaller than both the batch and the dataset: the JAX
    package's rule, for the same inputs."""
    loaders = _loaders(data_dir)
    if max_loaded:
        jq = JLimitation(loaders["jax"], max_loaded=max_loaded,
                         num_access_before_reload=5, n_load_jobs=1,
                         logger=JScreen(False))
        tq = LimitationQueue(loaders["port"], max_loaded=max_loaded,
                             num_access_before_reload=5, n_load_jobs=1,
                             logger=ScreenLogger(False))
    else:
        jq = JEager(loaders["jax"], logger=JScreen(False))
        tq = EagerQueue(loaders["port"], logger=ScreenLogger(False))
    jseq, tseq = _sequences({"jax": jq, "port": tq}, batch_size=batch_size)
    X, _, _ = tseq[0]
    jseq[0]
    assert getattr(jseq, "use_pool", True) == tseq.use_pool == pooled
    assert X.shape[0] == batch_size
    for q in (jq, tq):
        if max_loaded:
            q.loading_pool.de_register_dataset(q.dataset.identifier)


def test_batch_size_change_takes_effect_on_next_batch(queues):
    """What the Trainer's out-of-memory backoff does: the next pooled
    batch takes the new size."""
    _, tseq = _sequences(queues)
    assert tseq[0][0].shape[0] == 6
    tseq.batch_size = 4
    X, y, w = tseq[1]
    assert X.shape[0] == y.shape[0] == w.shape[0] == 4
    assert tseq.use_pool


def test_pooled_path_over_limitation_queue(data_dir):
    """max_loaded 2 of 3 images at batch 2: the pool keeps 2 slots, evicts
    by LRU as the queue cycles its images, never holds more than 2 images
    loaded at an access, and every batch meets the fg quota with labels in
    [0, n_classes)."""
    loader = _loaders(data_dir)["port"]
    queue = LimitationQueue(loader, max_loaded=2,
                            num_access_before_reload=2, n_load_jobs=1,
                            logger=ScreenLogger(False))
    seq = get_sequence(queue, intrp_style="iso_live", views=VIEWS, dim=32,
                       batch_size=2, n_classes=4, real_space_span=34.0,
                       noise_sd=0.1, fg_batch_fraction=1.0, no_log=True,
                       logger=ScreenLogger(False), device="cpu")
    # the sequence reseeds numpy from fresh entropy on its first batch in
    # a process (BaseSequence.seed); marked as seeded, it keeps this seed
    seq._seeded_pid = os.getpid()
    np.random.seed(0)
    seq[0]
    pool = seq._get_pool()
    assert seq.use_pool and pool.capacity == 2
    loaded, staged = [], set()
    ensure = pool.ensure

    def counting(image):
        loaded.append(loader.n_loaded)
        staged.add(image.identifier)
        return ensure(image)
    pool.ensure = counting
    for i in range(12):
        X, y, w = seq[i]
        labs = y.numpy()
        assert labs.min() >= 0 and labs.max() < 4
        assert all((el > 0).any() for el in labs)
    assert max(loaded) <= 2 and len(loaded) == 24
    assert len(staged) == 3  # all three images passed through 2 slots
    queue.loading_pool.de_register_dataset(loader.identifier)


def test_get_sequence_wraps_a_bare_loader(data_dir):
    """A bare ImagePairLoader is wrapped in a LazyQueue (as the JAX
    package does), so batches sample from it, equal to the JAX package's
    from its bare loader, and every image is unloaded after its draw."""
    loaders = _loaders(data_dir)
    jseq, tseq = _sequences(loaders)
    np.random.seed(8)
    jX, jy, jw = jseq[0]
    np.random.seed(8)
    tX, ty, tw = tseq[0]
    _assert_images_close(tX.numpy(), jX)
    assert (ty.numpy() == np.asarray(jy)).mean() >= 0.9999
    np.testing.assert_array_equal(tw, jw)
    assert type(tseq.image_pair_queue).__name__ == "LazyQueue"
    assert loaders["port"].n_loaded == 0
