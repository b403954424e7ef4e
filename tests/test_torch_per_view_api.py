"""The port's per-view inference API against the JAX package's:
`geometry.plane_axis`, `plane_offsets` and `sample_plane_grid`,
`interp.sample_plane_stack` and `map_view_pred_to_voxels`, the 2D
sequence's `plane_offsets` and `get_view_from`, and `predict_single` on
both branches with the same weights carried across by
`unet_state_dict_from_jax`. Inputs are seeded numpy arrays and one 32^3
toy subject under an oblique, anisotropic affine, read by both packages'
loaders; the port runs on the CPU. Each test's docstring states its
tolerance."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiplanarunet_tpu.bin.toy_data import create_toy_image
from multiplanarunet_tpu.hyperparameters import YAMLHParams as JHParams
from multiplanarunet_tpu.image import ImagePairLoader as JLoader
from multiplanarunet_tpu.image.queue import EagerQueue as JEager
from multiplanarunet_tpu.logging import ScreenLogger as JScreen
from multiplanarunet_tpu.models import checkpoint as jckpt
from multiplanarunet_tpu.models.unet import UNet as JUNet
from multiplanarunet_tpu.models.unet3d import UNet3D as JUNet3D
from multiplanarunet_tpu.ops import geometry as jgeo
from multiplanarunet_tpu.ops import interp as jinterp
from multiplanarunet_tpu.sequences import get_sequence as j_get_sequence
from multiplanarunet_tpu.utils.fusion import fuse_and_predict as jfp
from multiplanarunet_tpu_torch.hyperparameters.hparams import YAMLHParams
from multiplanarunet_tpu_torch.image.image_pair_loader import ImagePairLoader
from multiplanarunet_tpu_torch.image.queue.queues import EagerQueue
from multiplanarunet_tpu_torch.io import nifti
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.models import checkpoint as tckpt
from multiplanarunet_tpu_torch.models.unet import UNet
from multiplanarunet_tpu_torch.models.unet3d import UNet3D
from multiplanarunet_tpu_torch.ops import geometry as tgeo
from multiplanarunet_tpu_torch.ops import interp as tinterp
from multiplanarunet_tpu_torch.sequences import get_sequence
from multiplanarunet_tpu_torch.utils.fusion import fuse_and_predict as tfp
from tests.torch_projects import flax_init, torch_threads  # noqa: F401


SIZE, N_CLASSES, SPAN = 32, 4, 30.0
CPU = torch.device("cpu")
VIEWS = np.array([[0.0, 0.0, 1.0], [0.6, -0.3, 0.74], [1.0, 0.2, 0.1]])


def _oblique_affine():
    R = tgeo.rotation_matrix([0, 0, 1], angle_deg=25) @ \
        tgeo.rotation_matrix([1, 0, 0], angle_deg=10)
    affine = np.eye(4)
    affine[:3, :3] = R @ np.diag([1.0, 1.1, 0.9])
    return affine


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """One 32^3 toy subject (image and labels 0-3) under an oblique,
    anisotropic affine."""
    root = tmp_path_factory.mktemp("per_view")
    image, labels = create_toy_image(SIZE, 1, np.random.RandomState(3))
    for sub, arr in (("images", image), ("labels", labels)):
        (root / sub).mkdir()
        nifti.save(arr, root / sub / "subj.nii.gz", affine=_oblique_affine())
    return root


def _queues(data_dir):
    out = {}
    for name, loader_cls, queue_cls, log in (
            ("jax", JLoader, JEager, JScreen(False)),
            ("port", ImagePairLoader, EagerQueue, ScreenLogger(False))):
        loader = loader_cls(base_dir=data_dir, logger=log, no_log=True)
        loader.set_scaler_and_bg_values(bg_value=1.0,
                                        scaler="StandardScaler",
                                        compute_now=True)
        out[name] = queue_cls(loader, logger=log)
    return out


@pytest.fixture(scope="module")
def sequences(data_dir):
    queues = _queues(data_dir)
    kw = dict(intrp_style="iso_live", views=VIEWS, dim=SIZE, batch_size=2,
              n_classes=N_CLASSES, real_space_span=SPAN, noise_sd=0.0,
              no_log=True)
    return (queues,
            j_get_sequence(queues["jax"], logger=JScreen(False), **kw),
            get_sequence(queues["port"], logger=ScreenLogger(False),
                         device="cpu", **kw))


@pytest.mark.parametrize("span,dim", [(30.0, 32), (31, 32), (255.0, 256),
                                      (47.5, 17)])
def test_plane_axis_equal(span, dim):
    """plane_axis keeps the float floor division: bit-equal."""
    np.testing.assert_array_equal(tgeo.plane_axis(span, dim),
                                  jgeo.plane_axis(span, dim))


@pytest.mark.parametrize("n_planes", ["same", "same+4", 10, "by_radius"])
def test_plane_offsets_equal(sequences, n_planes):
    """The sequence's plane_offsets (one function shared with the
    predictor) against the JAX sequence's: bit-equal."""
    queues, jseq, tseq = sequences
    with queues["jax"].get_image_by_idx(0) as jimg, \
            queues["port"].get_image_by_idx(0) as timg:
        j = jseq.plane_offsets(jimg, n_planes)
        t = tseq.plane_offsets(timg, n_planes)
    np.testing.assert_array_equal(t, j)
    assert t.dtype == np.float32
    pred = tfp.MultiViewPredictor(torch.nn.Identity(), SIZE, SPAN, 2, CPU)
    with queues["port"].get_image_by_idx(0) as timg:
        np.testing.assert_array_equal(
            pred._prepare_offsets(timg, n_planes)[0][:len(t)], t)


@pytest.mark.parametrize("noise_sd", [0.0, 0.1])
def test_sample_plane_grid(noise_sd):
    """The (3, d, d, 1) grid, its axis and inverse basis, with the basis
    noise drawn from equal RandomStates: within 1e-6, and the two
    streams left equal."""
    j_rng, t_rng = np.random.RandomState(9), np.random.RandomState(9)
    for view, off in ((VIEWS[1], 3.5), (VIEWS[2], -7.25)):
        j = jgeo.sample_plane_grid(view, 24, SPAN, off, noise_sd=noise_sd,
                                   rng=j_rng, return_basis=True)
        t = tgeo.sample_plane_grid(view, 24, SPAN, off, noise_sd=noise_sd,
                                   rng=t_rng, return_basis=True)
        assert t[0].shape == (3, 24, 24, 1)
        for a, b in zip(t, j):
            np.testing.assert_allclose(a, b, atol=1e-6)
        np.testing.assert_allclose(
            tgeo.sample_plane_grid(view, 24, SPAN, off),
            jgeo.sample_plane_grid(view, 24, SPAN, off), atol=1e-6)
    assert j_rng.randint(1 << 30) == t_rng.randint(1 << 30)


def _stack_inputs(seed=0):
    """A random (28, 24, 20, 2) volume zero-padded to 32^3, an oblique
    alignment rotation and a view's basis and offsets."""
    rng = np.random.RandomState(seed)
    vol = np.zeros((32, 32, 32, 2), np.float32)
    vol[:28, :24, :20] = rng.rand(28, 24, 20, 2)
    origin = -np.array([27, 23, 19], np.float32) / 2 * np.float32(1.1)
    spacing = np.full(3, 1.1, np.float32)
    rot = jgeo.rotation_matrix([0.3, 1, 0.2], angle_deg=17).astype(
        np.float32)
    basis = jgeo.plane_basis(VIEWS[1])
    offsets = np.linspace(-16, 16, 21).astype(np.float32)
    return vol, origin, spacing, rot, basis, offsets


@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_sample_plane_stack(method):
    """The unpacked (d, d, P, C) stack over a padded volume with a valid
    extent, an oblique rotation and a fill: linear within 1e-5; nearest
    equal in >= 0.9999 of the values (a float32 tie may round either
    way)."""
    vol, origin, spacing, rot, basis, offsets = _stack_inputs()
    fill = np.array([0.5, -1.0], np.float32)
    valid = np.array([28, 24, 20], np.int32)
    j = np.asarray(jinterp.sample_plane_stack(
        jnp.asarray(vol), jnp.asarray(origin), jnp.asarray(spacing),
        jnp.asarray(rot), jnp.asarray(basis), jnp.asarray(offsets), SPAN, 24,
        jnp.asarray(fill), method=method, valid_shape=jnp.asarray(valid)))
    t = tinterp.sample_plane_stack(
        torch.from_numpy(vol), origin, spacing, rot, basis, offsets, SPAN, 24,
        fill, method=method, valid_shape=valid).numpy()
    assert t.shape == j.shape == (24, 24, 21, 2)
    assert t.dtype == np.float32
    if method == "linear":
        np.testing.assert_allclose(t, j, atol=1e-5)
    else:
        assert (t == j).mean() >= 0.9999
    assert (t == fill).all(-1).any() and not (t == fill).all(-1).all()


def test_get_view_from(sequences):
    """get_view_from on the oblique subject for three views: offsets,
    the real axis and inv_basis equal to the JAX tuple's; X within 1e-5
    absolute plus 1e-5 of each value (the StandardScaler's values reach
    4.3, and the two frameworks round the float32 rotation of the points
    differently, so a steep edge moves by a few float32 ulps); y equal
    in >= 0.9999 of the voxels; without labels y is None; the grid
    drives the port's map_real_space_pred (argmax of a one-hot stack
    equal to the JAX function's in >= 0.9999 of voxels)."""
    queues, jseq, tseq = sequences
    with queues["jax"].get_image_by_idx(0) as jimg, \
            queues["port"].get_image_by_idx(0) as timg:
        for view, spec in zip(VIEWS, ("same+4", "same", 20)):
            jX, jy, jgrid, jinv = jseq.get_view_from(jimg, view, spec)
            tX, ty, tgrid, tinv = tseq.get_view_from(timg, view, spec)
            P = len(jgrid[2])
            assert tX.shape == (SIZE, SIZE, P, 1) and tX.dtype == torch.float32
            assert ty.shape == (SIZE, SIZE, P) and ty.dtype == torch.int32
            for a, b in zip(tgrid, jgrid):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(tinv, jinv)
            np.testing.assert_allclose(tX.numpy(), np.asarray(jX),
                                       rtol=1e-5, atol=1e-5)
            assert (ty.numpy() == np.asarray(jy)).mean() >= 0.9999
        onehot = torch.nn.functional.one_hot(ty.long(), N_CLASSES).float()
        mapped = tfp.map_real_space_pred(onehot, tgrid, tinv, timg.affine,
                                         timg.shape)
        jmapped = jfp.map_real_space_pred(np.asarray(onehot.numpy()), jgrid,
                                          jinv, jimg.affine, jimg.shape)
        assert mapped.shape == (SIZE,) * 3 + (N_CLASSES,)
        assert (mapped.argmax(-1).numpy() == jmapped.argmax(-1)).mean() \
            >= 0.9999
        timg.predict_mode = True
        try:
            assert tseq.get_view_from(timg, VIEWS[0], "same")[1] is None
        finally:
            timg.predict_mode = False


def test_map_view_pred_to_voxels():
    """The gather of a (d, d, P, C) prediction stack at the real-space
    voxel grid of an oblique image, nearest and linear: nearest equal in
    >= 0.9999 of the values, linear within 1e-5; the one-hot background
    outside."""
    rng = np.random.RandomState(4)
    pred = rng.rand(24, 24, 30, 3).astype(np.float32)
    axis = tgeo.plane_axis(SPAN, 24)
    offsets = np.linspace(-15, 15, 30).astype(np.float32)
    span0 = np.array([axis[0], axis[1] - axis[0]], np.float32)
    off2 = np.array([offsets[0], offsets[1] - offsets[0]], np.float32)
    inv = np.linalg.inv(jgeo.plane_basis(VIEWS[1]).astype(np.float64)) \
        .astype(np.float32)
    pts = np.moveaxis(tgeo.get_voxel_grid_real_space(
        (26, 28, 22), _oblique_affine()), 0, -1).astype(np.float32)
    for method in ("nearest", "linear"):
        j = np.asarray(jinterp.map_view_pred_to_voxels(
            jnp.asarray(pred), jnp.asarray(span0), jnp.asarray(off2),
            jnp.asarray(inv), jnp.asarray(pts), method=method))
        t = tinterp.map_view_pred_to_voxels(
            torch.from_numpy(pred), span0, off2, inv, pts,
            method=method).numpy()
        assert t.shape == j.shape == (26, 28, 22, 3)
        if method == "nearest":
            assert (t == j).mean() >= 0.9999
        else:
            np.testing.assert_allclose(t, j, atol=1e-5)
        outside = (t == np.array([1.0, 0.0, 0.0], np.float32)).all(-1)
        assert outside.any() and not outside.all()


# ---------------------------------------------------------- predict_single
def _predict_hparams(root, style, views=None):
    """Both packages' hparams of a project folder whose train_hparams.yaml
    holds what predict_single reads (and views.npz for iso_live)."""
    root.mkdir()
    extra = ("  real_box_dim: 20\n" if style == "iso_live_3d" else "")
    (root / "train_hparams.yaml").write_text(
        "build:\n"
        f"  dim: {8 if style == 'iso_live_3d' else SIZE}\n"
        f"  n_classes: {N_CLASSES}\n"
        "fit:\n"
        f"  intrp_style: {style}\n"
        f"  real_space_span: {SPAN}\n"
        "  bg_value: 1.0\n"
        "  scaler: StandardScaler\n"
        "  noise_sd: 0.0\n"
        "  batch_size: 2\n" + extra)
    if views is not None:
        np.savez(root / "views.npz", views)
    return (JHParams(root / "train_hparams.yaml", logger=JScreen(False),
                     no_log=True, no_version_control=True),
            YAMLHParams(root / "train_hparams.yaml",
                        logger=ScreenLogger(False), no_log=True,
                        no_version_control=True))


def _jax_weights(jmodel, shape):
    """Seeded flax weights with the out conv sharpened (no near-ties) and
    BatchNorm statistics off their init, as numpy trees."""
    variables = flax_init(jmodel, jax.random.PRNGKey(1), shape)
    params = jax.tree.map(np.asarray, variables["params"])
    params["out_conv"]["kernel"] = params["out_conv"]["kernel"] * 6.0
    rng = np.random.RandomState(2)
    stats = jax.tree.map(
        lambda s: (0.1 * rng.rand(*s.shape) + (s == 1)).astype(np.float32),
        jax.tree.map(np.asarray, variables["batch_stats"]))
    return params, stats


def _probs(sums):
    return sums / np.maximum(sums.sum(-1, keepdims=True), 1e-8)


def _single_images(data_dir):
    queues = _queues(data_dir)
    return (queues["jax"].dataset.images[0],
            queues["port"].dataset.images[0])


def test_predict_single_iso_live(data_dir, tmp_path):
    """iso_live: every view's mapped probabilities (n_views, X, Y, Z, C)
    float32 on the host, views read from views.npz, against the JAX
    predict_single on the same weights: within atol 3e-2 (bf16
    probabilities on both sides), argmax equal in >= 0.99 of voxels."""
    jhp, thp = _predict_hparams(tmp_path / "proj", "iso_live", VIEWS[1:])
    kw = dict(n_classes=N_CLASSES, n_channels=1, depth=2, init_filters=8)
    jmodel = JUNet(dim=SIZE, **kw)
    params, stats = _jax_weights(jmodel, (1, SIZE, SIZE, 1))
    model = UNet(**kw)
    model.load_state_dict(tckpt.unet_state_dict_from_jax(params, stats,
                                                         model))
    jimg, timg = _single_images(data_dir)
    j = jfp.predict_single(jimg, jmodel, {"params": params,
                                          "batch_stats": stats}, jhp)
    t = tfp.predict_single(timg, model, thp, device="cpu")
    assert isinstance(t, np.ndarray) and t.dtype == np.float32
    assert t.shape == j.shape == (2, SIZE, SIZE, SIZE, N_CLASSES)
    np.testing.assert_allclose(t, j, atol=3e-2)
    assert (t.argmax(-1) == j.argmax(-1)).mean() >= 0.99
    assert len(np.unique(t.argmax(-1))) > 1
    # given views win over views.npz
    t1 = tfp.predict_single(timg, model, thp, views=VIEWS[1:2],
                            device="cpu")
    np.testing.assert_array_equal(t1, t[:1])


def test_predict_single_iso_live_3d(data_dir, tmp_path):
    """iso_live_3d: pred_3D_iso's box sums with 3x extra boxes over a
    one-image sequence, the extra placements drawn from equal numpy
    states: the sums normalised to probabilities within atol 3e-2,
    argmax equal in >= 0.99 of voxels."""
    jhp, thp = _predict_hparams(tmp_path / "proj3d", "iso_live_3d")
    kw = dict(n_classes=N_CLASSES, n_channels=1, depth=2, init_filters=4)
    jmodel = JUNet3D(dim=8, **kw)
    params, stats = _jax_weights(jmodel, (1, 8, 8, 8, 1))
    model = UNet3D(**kw)
    model.load_state_dict(tckpt.unet_state_dict_from_jax(params, stats,
                                                         model))
    jimg, timg = _single_images(data_dir)
    np.random.seed(11)
    j = jfp.predict_single(jimg, jmodel, {"params": params,
                                          "batch_stats": stats}, jhp)
    np.random.seed(11)
    t = tfp.predict_single(timg, model, thp, device="cpu")
    assert t.shape == j.shape == (SIZE,) * 3 + (N_CLASSES,)
    assert t.dtype == np.float32
    np.testing.assert_allclose(_probs(t), _probs(j), atol=3e-2)
    assert (t.argmax(-1) == j.argmax(-1)).mean() >= 0.99
    covered = t.sum(-1) > 0
    assert (covered == (j.sum(-1) > 0)).mean() >= 0.99 and covered.mean() > 0.2


def test_predict_single_named_errors(data_dir, tmp_path):
    """A call in the JAX form (image, model, variables, hparams) raises a
    TypeError naming the dropped `variables`; an intrp_style other than
    iso_live / iso_live_3d raises the JAX package's ValueError in both
    packages."""
    jhp, thp = _predict_hparams(tmp_path / "perr", "iso_live", VIEWS)
    jimg, timg = _single_images(data_dir)
    model = UNet(n_classes=N_CLASSES, depth=2, init_filters=4)
    with pytest.raises(TypeError, match="variables"):
        tfp.predict_single(timg, model, {"params": {}}, thp)
    jhp["fit"]["intrp_style"] = "patches_3d"
    thp["fit"]["intrp_style"] = "patches_3d"
    with pytest.raises(ValueError, match="supports iso_live modes") as je:
        jfp.predict_single(jimg, None, None, jhp)
    with pytest.raises(ValueError, match="supports iso_live modes") as te:
        tfp.predict_single(timg, model, thp, device="cpu")
    assert str(te.value) == str(je.value)
