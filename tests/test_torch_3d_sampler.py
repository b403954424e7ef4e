"""The port's 3D samplers against the JAX package's on one toy dataset
and one np.random seed: iso_live_3d batches on the pooled and the
per-image path with the same candidate choices (images within 1e-5 of the
batch's scale, labels equal on >= 0.9999 of voxels, weights equal), its
inference generators, and the patches_3d / sliding_patches_3d batches
and corners bit-equal."""
import numpy as np
import pytest
import torch

from multiplanarunet_tpu.bin.toy_data import create_dataset
from multiplanarunet_tpu.image import ImagePairLoader as JLoader
from multiplanarunet_tpu.image.queue import EagerQueue as JEager
from multiplanarunet_tpu.logging import ScreenLogger as JScreen
from multiplanarunet_tpu.sequences import get_sequence as j_get_sequence
from multiplanarunet_tpu_torch.image.image_pair_loader import ImagePairLoader
from multiplanarunet_tpu_torch.image.queue.queues import EagerQueue
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.sequences import get_sequence
from tests.torch_projects import torch_threads  # noqa: F401


ISO = dict(intrp_style="iso_live_3d", dim=16, batch_size=4, n_classes=4,
           real_box_dim=8.0, noise_sd=0.1, fg_batch_fraction=0.5,
           no_log=True)


@pytest.fixture(scope="module")
def queues(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy_3d")
    create_dataset(root / "train", 3, 32, 1, np.random.RandomState(7),
                   "train", pixdim=(1.0, 1.1, 0.9))
    out = {}
    for name, loader_cls, queue_cls, log in (
            ("jax", JLoader, JEager, JScreen(False)),
            ("port", ImagePairLoader, EagerQueue, ScreenLogger(False))):
        loader = loader_cls(base_dir=root / "train", logger=log, no_log=True)
        loader.set_scaler_and_bg_values(bg_value="1pct",
                                        scaler="RobustScaler")
        out[name] = queue_cls(loader, logger=log)
    return out


def _sequences(queues, **over):
    kw = {**ISO, **over}
    jseq = j_get_sequence(queues["jax"], logger=JScreen(False), **kw)
    tseq = get_sequence(queues["port"], logger=ScreenLogger(False),
                        device="cpu", **kw)
    picks = {}
    for name, seq in (("jax", jseq), ("port", tseq)):
        seq.seed = lambda: None  # the test seeds numpy itself
        rec = picks[name] = []
        select = seq.select_candidate

        def recording(*a, select=select, rec=rec):
            out = select(*a)
            rec.append(out[0])
            return out
        seq.select_candidate = recording
    return jseq, tseq, picks


def _assert_batches_match(tbatch, jbatch, d=16):
    tX, ty, tw = tbatch
    jX, jy, jw = (np.asarray(a) for a in jbatch)
    assert tX.shape == jX.shape == (len(tw), d, d, d, 1)
    assert ty.shape == jy.shape and ty.dtype == torch.int32
    # within 1e-5 of the batch's largest scaled intensity: the sklearn and
    # numpy RobustScaler fits agree to float32 rounding
    err = np.abs(tX.numpy() - jX).max()
    assert err <= 1e-5 * np.abs(jX).max(), err
    equal = (ty.numpy() == jy).mean()
    assert equal >= 0.9999, equal
    np.testing.assert_array_equal(tw, jw)


@pytest.mark.parametrize("pooled,fraction,force", [
    (True, 0.5, "auto"), (True, 1.0, True), (False, 0.5, "auto")])
def test_iso_live_3d_batches_match_jax(queues, pooled, fraction, force):
    """3 consecutive batches under one seed on the pooled path (against
    the JAX package's pooled path) or the per-image path (against its
    per-image path), with the same candidate choices."""
    jseq, tseq, picks = _sequences(queues, fg_batch_fraction=fraction,
                                   force_all_fg=force)
    jseq.use_pool = tseq.use_pool = pooled
    batches = {}
    for name, seq in (("jax", jseq), ("port", tseq)):
        np.random.seed(31)
        batches[name] = [seq[i] for i in range(3)]
    assert tseq.use_pool == pooled and (tseq._pool is not None) == pooled
    for tb, jb in zip(batches["port"], batches["jax"]):
        _assert_batches_match(tb, jb)
    assert picks["port"] == picks["jax"]
    assert any(p > 0 for p in picks["port"])  # retries were exercised


def test_iso_live_3d_pooled_elastic3d_weights_match_jax(queues):
    """With Elastic3D (seeded) on the pooled path, the augmented boxes'
    weights equal the JAX package's, the augmenter's numpy stream ends
    where the JAX one ends, and the deformed boxes are the JAX package's:
    the same batch keys give the same noise fields, so the boxes agree as
    the unaugmented batches do (within 1e-5 of the largest intensity,
    labels on >= 0.9999 of voxels)."""
    aug = [{"cls_name": "Elastic3D",
            "kwargs": {"alpha": [0, 450], "sigma": [12, 25],
                       "apply_prob": 0.5, "seed": 5}}]
    jseq, tseq, _ = _sequences(queues, augmenters=aug)
    batches = {}
    for name, seq in (("jax", jseq), ("port", tseq)):
        np.random.seed(4)
        batches[name] = [seq[i] for i in range(2)]
    weights = {k: [b[2] for b in v] for k, v in batches.items()}
    for got, want in zip(weights["port"], weights["jax"]):
        np.testing.assert_array_equal(got, want)
    for (tX, ty, _), (jX, jy, _) in zip(batches["port"], batches["jax"]):
        jX = np.asarray(jX)
        assert tX.shape == jX.shape and ty.dtype == torch.float32
        err = np.abs(tX.numpy() - jX).max()
        assert err <= 1e-5 * np.abs(jX).max(), err
        equal = (ty.numpy() == np.asarray(jy)).mean()
        assert equal >= 0.9999, equal
    assert any((w != 1.0).any() for w in weights["port"])
    state = lambda s: s.list_of_augmenters[0]._rng.randint(1 << 30)  # noqa
    assert state(tseq) == state(jseq)


def test_iso_live_3d_inference_generators_match_jax(queues):
    """base_placements, the base boxes with their labels, axes and inverse
    rotations, then N random boxes under one seed."""
    jseq, tseq, _ = _sequences(queues, real_box_dim=14.0)
    jimage = queues["jax"].dataset.images[1]
    timage = queues["port"].dataset.images[1]
    np.testing.assert_array_equal(tseq.base_placements(timage),
                                  jseq.base_placements(jimage))
    np.random.seed(8)
    want = list(jseq.get_base_patches_from(jimage, return_y=True)) + list(
        jseq.get_N_random_patches_from(jimage, 3, return_y=True))
    np.random.seed(8)
    got = list(tseq.get_base_patches_from(timage, return_y=True)) + list(
        tseq.get_N_random_patches_from(timage, 3, return_y=True))
    assert len(got) == len(want) == len(jseq.base_placements(jimage)) + 3
    scale = max(np.abs(np.asarray(w[0])).max() for w in want)
    for g, w in zip(got, want):
        assert np.abs(g[0].numpy() - np.asarray(w[0])).max() <= 1e-5 * scale
        assert (g[1].numpy() == np.asarray(w[1])).mean() >= 0.9999
        for a, b in zip(g[2:], w[2:]):  # corner, axes, inv_rot[, total]
            np.testing.assert_array_equal(np.asarray(a, dtype=object)
                                          if isinstance(a, tuple) else a,
                                          np.asarray(b, dtype=object)
                                          if isinstance(b, tuple) else b)


@pytest.mark.parametrize("style,extra", [
    ("patches_3d", {}), ("sliding_patches_3d", {"strides": 6})])
def test_patch_sequences_bit_equal_to_jax(queues, style, extra):
    """Training batches (3, under one seed), the base corners and the
    prediction generator's patches and corners, bit-equal."""
    kw = dict(intrp_style=style, dim=12, batch_size=5, n_classes=4,
              fg_batch_fraction=0.6, no_log=True, **extra)
    jseq = j_get_sequence(queues["jax"], logger=JScreen(False), **kw)
    tseq = get_sequence(queues["port"], logger=ScreenLogger(False),
                        device="cpu", **kw)
    for seq in (jseq, tseq):
        seq.seed = lambda: None
    batches = {}
    for name, seq in (("jax", jseq), ("port", tseq)):
        np.random.seed(17)
        batches[name] = [seq[i] for i in range(3)]
    for (tX, ty, tw), (jX, jy, jw) in zip(batches["port"], batches["jax"]):
        assert tX.shape == (5, 12, 12, 12, 1) and tX.dtype == torch.float32
        np.testing.assert_array_equal(tX.numpy(), jX)
        np.testing.assert_array_equal(ty.numpy(), jy)
        np.testing.assert_array_equal(tw, jw)
    jimage = queues["jax"].dataset.images[0]
    timage = queues["port"].dataset.images[0]
    np.testing.assert_array_equal(tseq.base_corners(timage),
                                  jseq.base_corners(jimage))
    np.random.seed(3)
    want = list(jseq.get_patches_from(jimage, n_extra=4))
    np.random.seed(3)
    got = list(tseq.get_patches_from(timage, n_extra=4))
    assert len(got) == len(want) > 4
    for (tp, tc, ts), (jp, jc, js) in zip(got, want):
        np.testing.assert_array_equal(tp, jp)
        assert tuple(int(c) for c in tc) == tuple(int(c) for c in jc)
        assert ts == js
