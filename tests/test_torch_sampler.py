"""The port's training sampler against the JAX package's per-image path,
on the same toy NIfTI data and the same numpy seed: batches (images within
1e-5 relative, labels equal on >= 0.9999 of pixels, weights equal, the same
accepted candidates), the plane gathers, `plane_basis_batch`, the
elastic deformation fed the JAX noise fields, and the Elastic2D host
draws."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiplanarunet_tpu.augmentation import Elastic2D as JElastic2D
from multiplanarunet_tpu.bin.toy_data import create_dataset
from multiplanarunet_tpu.image import ImagePairLoader as JLoader
from multiplanarunet_tpu.image.queue import EagerQueue as JEager
from multiplanarunet_tpu.logging import ScreenLogger as JScreen
from multiplanarunet_tpu.ops import elastic as jelastic
from multiplanarunet_tpu.ops import geometry as jgeo
from multiplanarunet_tpu.ops import interp as jinterp
from multiplanarunet_tpu.sequences import get_sequence as j_get_sequence
from multiplanarunet_tpu_torch.augmentation.augmenters import (
    Elastic2D,
    Elastic3D,
    build_augmenters,
)
from multiplanarunet_tpu_torch.image.image_pair_loader import ImagePairLoader
from multiplanarunet_tpu_torch.image.queue.queues import EagerQueue
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.ops import elastic as telastic
from multiplanarunet_tpu_torch.ops import geometry as tgeo
from multiplanarunet_tpu_torch.ops import interp as tinterp
from multiplanarunet_tpu_torch.sequences import get_sequence
from multiplanarunet_tpu_torch.sequences.iso_3d import (
    IsotrophicLiveViewSequence3D,
)
from multiplanarunet_tpu_torch.sequences.patches_3d import (
    PatchSequence3D,
    SlidingPatchSequence3D,
)
from tests.torch_projects import torch_threads  # noqa: F401


VIEWS = jgeo.sample_random_views_with_angle_restriction(
    3, 60, rng=np.random.RandomState(2))


@pytest.fixture(scope="module")
def queues(tmp_path_factory):
    root = tmp_path_factory.mktemp("sampler_toy")
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
    kw = dict(intrp_style="iso_live", views=VIEWS, dim=32, batch_size=6,
              n_classes=4, real_space_span=34.0, noise_sd=0.1,
              fg_batch_fraction=0.5, no_log=True)
    kw.update(over)
    jseq = j_get_sequence(queues["jax"], logger=JScreen(False), **kw)
    jseq.use_pool = False
    tseq = get_sequence(queues["port"], logger=ScreenLogger(False),
                        device="cpu", **kw)
    tseq.use_pool = False
    choices = {}
    for name, seq in (("jax", jseq), ("port", tseq)):
        seq.seed = lambda: None  # the test seeds numpy itself
        picks = choices[name] = []
        select = seq.select_candidate

        def recording(*a, select=select, picks=picks):
            out = select(*a)
            picks.append(out[0])
            return out
        seq.select_candidate = recording
    return jseq, tseq, choices


@pytest.mark.parametrize("fraction,force", [(0.5, "auto"), (1.0, True)])
def test_batches_match_jax_per_image_path(queues, fraction, force):
    jseq, tseq, choices = _sequences(queues, fg_batch_fraction=fraction,
                                     force_all_fg=force)
    for seed in (11, 12):
        np.random.seed(seed)
        jX, jy, jw = jseq[0]
        np.random.seed(seed)
        tX, ty, tw = tseq[0]
        assert tX.shape == tuple(jX.shape) and ty.shape == tuple(jy.shape)
        # 1e-5 relative: the sklearn and numpy RobustScaler fits agree to
        # float32 rounding, and scaled intensities reach about 4
        np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=1e-5,
                                   atol=1e-5)
        equal = (ty.numpy() == np.asarray(jy)).mean()
        assert equal >= 0.9999, equal
        np.testing.assert_array_equal(tw, jw)
    assert choices["port"] == choices["jax"]
    assert any(c > 0 for c in choices["port"])  # retries were exercised


def test_sequence_named_errors(queues):
    """The three 3D styles build (the patch styles without augmenters),
    Elastic3D builds, and an unknown style or augmenter raises
    ValueError."""
    aug = [{"cls_name": "Elastic3D",
            "kwargs": {"alpha": 1, "sigma": 1, "apply_prob": 1}}]
    for style, cls, kw in (
            ("iso_live_3d", IsotrophicLiveViewSequence3D,
             dict(real_box_dim=20.0, augmenters=aug)),
            ("patches_3d", PatchSequence3D, dict(augmenters=aug)),
            ("sliding_patches_3d", SlidingPatchSequence3D,
             dict(strides=8))):
        seq = get_sequence(queues["port"], intrp_style=style, dim=16,
                           batch_size=2, n_classes=4, no_log=True,
                           device="cpu", **kw)
        assert type(seq) is cls
    assert isinstance(seq.strides, int) and seq.strides == 8
    augs = get_sequence(queues["port"], intrp_style="iso_live_3d", dim=16,
                        batch_size=2, n_classes=4, real_box_dim=20.0,
                        augmenters=aug, no_log=True,
                        device="cpu").list_of_augmenters
    assert [type(a) for a in augs] == [Elastic3D]
    assert type(build_augmenters(aug)[0]) is Elastic3D
    with pytest.raises(ValueError, match="intrp_style"):
        get_sequence(queues["port"], intrp_style="iso_live_4d", dim=16,
                     batch_size=2, n_classes=4, device="cpu")
    with pytest.raises(ValueError, match="augmenter"):
        build_augmenters([{**aug[0], "cls_name": "Elastic4D"}])


def test_plane_basis_batch_and_plane_gathers_match_jax():
    rng = np.random.RandomState(0)
    views = np.concatenate([VIEWS, [[0.0, 0.0, 1.0]]])[rng.randint(0, 4, 12)]
    for noise in (0.0, 0.1):
        np.random.seed(5)
        a = jgeo.plane_basis_batch(views, noise_sd=noise)
        np.random.seed(5)
        b = tgeo.plane_basis_batch(views, noise_sd=noise)
        np.testing.assert_array_equal(a, b)
    vol = rng.rand(20, 22, 18, 2).astype(np.float32)
    lab = rng.randint(0, 5, (20, 22, 18, 1)).astype(np.float32)
    origin = np.array([-9.5, -10.5, -8.5], np.float32) * [1.0, 1.1, 0.9]
    spacing = np.array([1.0, 1.1, 0.9], np.float32)
    rot = jgeo.rotation_matrix([0.3, 0.2, 1.0], 20).astype(np.float32)
    bases = jgeo.plane_basis_batch(VIEWS[[0, 1, 2, 1]], noise_sd=0.0)
    offsets = np.array([-4.0, 0.0, 2.5, 7.0], np.float32)
    valid = (20, 22, 17)
    for values, method, fill in ((vol, "linear", [0.5, -1.0]),
                                 (lab, "nearest", 3.0)):
        want = np.asarray(jinterp.sample_plane_batch(
            jnp.asarray(values), origin, spacing, jnp.asarray(rot),
            jnp.asarray(bases), jnp.asarray(offsets), 24.0, 16,
            jnp.asarray(fill, jnp.float32), method=method,
            valid_shape=jnp.asarray(valid)))
        got = tinterp.sample_plane_batch(
            torch.from_numpy(values), origin, spacing, torch.from_numpy(rot),
            bases, offsets, 24.0, 16, fill, method=method,
            valid_shape=valid).numpy()
        if method == "linear":
            np.testing.assert_allclose(got, want, atol=1e-5)
        else:
            assert (got == want).mean() >= 0.9999
        one = tinterp.sample_plane(
            torch.from_numpy(values), origin, spacing, rot, bases[2],
            float(offsets[2]), 24.0, 16, fill, method=method,
            valid_shape=valid).numpy()
        np.testing.assert_array_equal(one, got[2])


def _jax_fields(key, B, d):
    kx, ky = jax.random.split(key)
    fx = jax.random.uniform(kx, (B, d, d), minval=-1.0, maxval=1.0)
    fy = jax.random.uniform(ky, (B, d, d), minval=-1.0, maxval=1.0)
    return np.asarray(fx), np.asarray(fy)


def test_elastic_deform_matches_jax_given_its_fields():
    """Fed the JAX noise fields: images within 1e-4 (displacements of up
    to alpha=200 pixels pass through a 129-tap blur summed in another
    order), labels equal on >= 0.999 of pixels, unapplied samples
    untouched."""
    rng = np.random.RandomState(0)
    B, d, C = 4, 48, 2
    images = rng.rand(B, d, d, C).astype(np.float32)
    labels = rng.randint(0, 4, (B, d, d)).astype(np.float32)
    alphas = np.array([0.0, 120.0, 200.0, 60.0], np.float32)
    sigmas = np.array([20.0, 22.0, 30.0, 25.0], np.float32)
    apply = np.array([True, True, True, False])
    bg = rng.rand(B, C).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want_x, want_y = jelastic.elastic_deform_2d_batch(
        key, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(alphas),
        jnp.asarray(sigmas), jnp.asarray(apply), jnp.asarray(bg))
    fx, fy = _jax_fields(key, B, d)
    got_x, got_y = telastic.elastic_deform_2d_fields(
        torch.from_numpy(images), torch.from_numpy(labels),
        torch.from_numpy(fx.copy()), torch.from_numpy(fy.copy()), alphas, sigmas, apply,
        bg)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=1e-4)
    assert (got_y.numpy() == np.asarray(want_y)).mean() >= 0.999
    np.testing.assert_array_equal(got_x[3].numpy(), images[3])
    assert not np.allclose(got_x[2].numpy(), images[2])


def test_smooth_fields_match_scipy():
    """The per-sample truncated gaussian blur equals scipy's
    gaussian_filter(mode='constant') within 2e-4 (the JAX package's
    pin)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.RandomState(0)
    fields = (rng.rand(2, 48, 48) * 2 - 1).astype(np.float32)
    sigmas = np.array([3.0, 7.5], np.float32)
    got = telastic.smooth_fields(torch.from_numpy(fields),
                                 torch.from_numpy(sigmas), radius=40).numpy()
    for i, s in enumerate(sigmas):
        want = gaussian_filter(fields[i], float(s), mode="constant", cval=0.0)
        np.testing.assert_allclose(got[i], want, atol=2e-4)


@pytest.mark.parametrize("seed", [5, None])
def test_elastic2d_host_draws_match_jax(seed):
    """Same seed, same order of numpy draws: the same samples augmented,
    aug_weight on exactly those, the augmenter's RandomState left in the
    same state (seed None draws the key's seed first, as the JAX package
    does), the same base key and the JAX package's deformed batches
    (images within 1e-4, labels equal on >= 0.999 of pixels, as for its
    fields above)."""
    kw = dict(alpha=[0, 450], sigma=[20, 30], apply_prob=0.5)
    if seed is None:
        np.random.seed(0)  # RandomState(None) draws OS entropy: compare
        j = JElastic2D(**kw)                       # states instead
        t = Elastic2D(**kw)
        t._rng.set_state(j._rng.get_state())
        t._key = np.asarray(j.base_key)
    else:
        j, t = JElastic2D(seed=seed, **kw), Elastic2D(seed=seed, **kw)
    rng = np.random.RandomState(1)
    x = rng.rand(8, 16, 16, 1).astype(np.float32)
    y = rng.randint(0, 3, (8, 16, 16, 1)).astype(np.float32)
    for _ in range(2):
        jx, jy, jw = j(jnp.asarray(x), jnp.asarray(y),
                       batch_w=np.ones(8, np.float32),
                       bg_values=np.zeros((8, 1)))
        tx, ty, tw = t(torch.from_numpy(x), torch.from_numpy(y),
                       batch_w=np.ones(8, np.float32),
                       bg_values=np.zeros((8, 1)))
        np.testing.assert_array_equal(tw, jw)
        changed = ~np.isclose(tx.numpy(), x).all(axis=(1, 2, 3))
        np.testing.assert_array_equal(changed, jw != 1.0)
        assert ty.shape == (8, 16, 16) and tx.dtype == torch.float32
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)
        assert (ty.numpy() == np.asarray(jy)).mean() >= 0.999
    assert t._rng.randint(1 << 30) == j._rng.randint(1 << 30)
    np.testing.assert_array_equal(t.base_key, np.asarray(j.base_key))
