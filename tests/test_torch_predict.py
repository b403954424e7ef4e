"""The port's MultiViewPredictor against the JAX package's, resampler by
resampler (shear, gather, auto's fallback, mixed mode, channel-grouped
remap), u8 staging and the on-device eval counts; and the oracle
reconstructions on the port alone."""
import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from multiplanarunet_tpu.image.volume_sampler import (
    VolumeSampler as JVolumeSampler,
)
from multiplanarunet_tpu.models import checkpoint as jckpt
from multiplanarunet_tpu.models.unet import UNet as JUNet
from multiplanarunet_tpu.ops import geometry as jgeo
from multiplanarunet_tpu.ops.shear import plan_view_remap as j_plan_remap
from multiplanarunet_tpu.utils.fusion import (
    MultiViewPredictor as JMultiViewPredictor,
)
from multiplanarunet_tpu.utils.fusion.fuse_and_predict import (
    _class_map_counts as j_class_map_counts,
    _unpack_class_map,
)
from multiplanarunet_tpu_torch.image.volume_sampler import VolumeSampler
from multiplanarunet_tpu_torch.models import checkpoint as tckpt
from multiplanarunet_tpu_torch.models.unet import UNet
from multiplanarunet_tpu_torch.ops.shear_plan import (
    plan_stage_bytes,
    plan_view_remap,
)
from multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict import (
    MultiViewPredictor,
    class_map_counts,
)
from tests.torch_projects import flax_init, torch_threads  # noqa: F401


SIZE = 32
N_CLASSES = 3
CPU = torch.device("cpu")


class _Image:
    """Minimal ImagePair stand-in: shape, affine, interpolator."""

    def __init__(self, volume, affine, sampler):
        self.shape = volume.shape
        self.affine = affine
        self.interpolator = sampler


def _rotated_affine():
    R = jgeo.rotation_matrix([0, 0, 1], angle_deg=25) @ \
        jgeo.rotation_matrix([1, 0, 0], angle_deg=10)
    affine = np.eye(4)
    affine[:3, :3] = R
    return affine


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Factory of (JAX predictor, port predictor) pairs on the same small
    UNet weights, carried through the checkpoint format, plus the JAX and
    port images of one rotated volume."""
    kw = dict(n_classes=N_CLASSES, n_channels=1, depth=2, init_filters=8)
    jmodel = JUNet(dim=SIZE, **kw)
    variables = flax_init(jmodel, jax.random.PRNGKey(0), (1, SIZE, SIZE, 1))
    rng = np.random.RandomState(0)
    # Sharpen the out conv so class decisions are not near-ties
    params = jax.tree.map(np.asarray, variables["params"])
    params["out_conv"]["kernel"] = params["out_conv"]["kernel"] * 8.0
    params["out_conv"]["bias"] = np.zeros(N_CLASSES, np.float32)
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    path = tmp_path_factory.mktemp("w") / "unet.npz"
    jckpt.save_weights(path, params, stats)
    p, s, _ = tckpt.load_weights(path)
    model = UNet(**kw)
    model.load_state_dict(tckpt.unet_state_dict_from_jax(p, s, model))
    model.eval()

    from scipy import ndimage

    vol = ndimage.gaussian_filter(rng.randn(SIZE, SIZE, SIZE), 2.0)
    vol = (vol / vol.std())[..., None].astype(np.float32)
    affine = _rotated_affine()
    jimg = _Image(vol, affine, JVolumeSampler(vol, None, affine, 0.0))
    timg = _Image(vol, affine, VolumeSampler(vol, affine, 0.0))
    assert timg.interpolator.rot_mat is not None  # rotation path active

    shared = {}

    def make(resampler, force=None, **tkw):
        """A new port predictor, and the JAX predictor of `resampler`: one
        for every call without `force` (its jitted functions are cached
        per instance, as `mp predict` keeps one over its images), a new
        one for a call that forces a path on both."""
        jpred = shared.get(resampler) if force is None else None
        if jpred is None:
            jpred = JMultiViewPredictor(
                jmodel, {"params": params, "batch_stats": stats},
                sample_dim=SIZE, real_space_span=float(SIZE - 1),
                n_classes=N_CLASSES, resampler=resampler)
            if force is None:
                shared[resampler] = jpred
        tpred = MultiViewPredictor(model, sample_dim=SIZE,
                                   real_space_span=float(SIZE - 1),
                                   n_classes=N_CLASSES, device=CPU,
                                   resampler=resampler, **tkw)
        if force is not None:
            force(jpred, tpred)
        return jpred, tpred

    return make, jimg, timg


def _fusion(n_views, seed=7):
    rngw = np.random.RandomState(seed)
    return {"fusion": {
        "W": (1.0 + 0.3 * rngw.rand(n_views, N_CLASSES)).astype(np.float32),
        "b": (0.2 * rngw.randn(1, N_CLASSES)).astype(np.float32)}}


def _force_auto_fallback(jpred, tpred):
    # Every plane-stack stage is over budget: auto takes the gather path
    jpred._SHEAR_STAGE_BYTES_MAX = 1.0
    tpred.stage_bytes_max = 1.0


def _force_mixed(jpred, tpred):
    # The stacks fit, no remap does: shear stack + gather remap per view
    jpred._SHEAR_REMAP_PEAK_BYTES_MAX = 0
    tpred.remap_peak_bytes_max = 0


@pytest.mark.parametrize("resampler,learned,force,modes", [
    ("shear", False, None, {"shear"}),
    ("shear", True, None, {"shear"}),
    ("gather", True, None, {"gather"}),
    ("auto", True, _force_auto_fallback, {"gather"}),
    ("shear", True, _force_mixed, {"gather-remap"}),
])
def test_port_matches_jax_predictor(setup, resampler, learned, force, modes):
    """Same weights, volume, views and fusion through both predictors.
    Both cast the U-Net probabilities to bf16; on the shear path both
    resample in bf16 (JAX's CPU take form multiplies and sums taps in
    bf16, the port sums in f32), so fused probabilities agree to a few
    bf16 ulps of 1: atol 3e-2. Class maps agree except at near-ties:
    >= 0.99."""
    make, jimg, timg = setup
    jpred, tpred = make(resampler, force)
    views = jgeo.get_random_views(3, rng=np.random.RandomState(5))
    fp = _fusion(3) if learned else None
    j_probs, j_pv = jpred.predict_image(jimg, views, fusion_params=fp,
                                        n_planes="same+8", return_probs=True)
    t_probs, t_pv = tpred.predict_image(timg, views, fusion_params=fp,
                                        n_planes="same+8", return_probs=True)
    assert set(tpred.remap_modes) == modes
    t_cls, none_pv = tpred.predict_image(timg, views, fusion_params=fp,
                                         n_planes="same+8",
                                         return_per_view=False)
    assert none_pv is None
    assert t_probs.shape == j_probs.shape == (SIZE,) * 3 + (N_CLASSES,)
    assert t_cls.dtype == np.uint8 and t_cls.shape == (SIZE,) * 3
    np.testing.assert_allclose(t_probs, j_probs, atol=3e-2)
    np.testing.assert_array_equal(t_cls, t_probs.argmax(-1))
    assert (t_cls == j_probs.argmax(-1)).mean() >= 0.99
    # the map is not degenerate
    counts = np.bincount(t_cls.ravel(), minlength=N_CLASSES)
    assert counts.max() < 0.9 * t_cls.size
    assert len(t_pv) == len(j_pv) == 3
    for a, b in zip(t_pv, j_pv):
        assert a.dtype == np.uint8
        assert (a == b).mean() >= 0.99


def _group2_budget(tpred, timg, views, n_planes):
    """A stage budget under which every view's remap runs in channel
    groups of 2: the largest group-of-2 remap stage, below every view's
    all-classes stage."""
    sampler = timg.interpolator
    offsets, _ = tpred._prepare_offsets(timg, n_planes)
    g0, g_step, o0, o_step = tpred._grid_params(offsets)
    vol_shape = sampler.padded_shape()
    stages = []
    for view in views:
        basis = jgeo.plane_basis(view)
        M, t = tpred._remap_transform(timg, basis, timg.shape[:3])
        r_plan, _ = j_plan_remap(M, t, g0, g_step, o0, o_step,
                                 (SIZE, SIZE, len(offsets)), vol_shape)
        stages.append((plan_stage_bytes(r_plan, 2),
                       plan_stage_bytes(r_plan, N_CLASSES)))
    limit = max(r2 for r2, _ in stages)
    assert all(r_all > limit for _, r_all in stages)
    return limit


def test_grouped_remap_matches_jax_grouped(setup, monkeypatch):
    """The channel-grouped remap, forced to groups of 2 through the port's
    guard attributes and through the JAX package's MP_SHEAR_CH_GROUP:
    the whole prediction within the shear tolerance, and each view's
    grouped remap of one random stack within bf16 rounding of the JAX
    one (atol 2e-2, argmax >= 0.98, as the JAX package holds its grouped
    remap to its ungrouped one)."""
    make, jimg, timg = setup
    jpred, tpred = make("shear")
    views = jgeo.get_random_views(3, rng=np.random.RandomState(5))
    tpred.stage_bytes_max = _group2_budget(tpred, timg, views, "same+8")
    monkeypatch.setenv("MP_SHEAR_CH_GROUP", "2")
    fp = _fusion(3)
    j_probs, _ = jpred.predict_image(jimg, views, fusion_params=fp,
                                     n_planes="same+8", return_probs=True,
                                     return_per_view=False)
    t_probs, _ = tpred.predict_image(timg, views, fusion_params=fp,
                                     n_planes="same+8", return_probs=True,
                                     return_per_view=False)
    assert tpred.remap_modes == ["grouped:2"] * 3
    np.testing.assert_allclose(t_probs, j_probs, atol=3e-2)
    assert (t_probs.argmax(-1) == j_probs.argmax(-1)).mean() >= 0.99

    # Remap alone, on one random probability stack
    offsets, n_valid = tpred._prepare_offsets(timg, "same+8")
    g0, g_step, o0, o_step = tpred._grid_params(offsets)
    vol_shape = timg.interpolator.padded_shape()
    rng = np.random.RandomState(0)
    stack = rng.rand(SIZE, SIZE, len(offsets), N_CLASSES).astype(np.float32)
    stack /= stack.sum(-1, keepdims=True)
    stack_bf16 = torch.from_numpy(stack).to(torch.bfloat16)
    for view in views[:2]:
        basis = jgeo.plane_basis(view)
        M, t = tpred._remap_transform(timg, basis, timg.shape[:3])
        r_plan, r_Nc = j_plan_remap(M, t, g0, g_step, o0, o_step,
                                    (SIZE, SIZE, len(offsets)), vol_shape)
        t_plan, t_Nc = plan_view_remap(M, t, g0, g_step, o0, o_step,
                                       (SIZE, SIZE, len(offsets)), vol_shape)
        bounds = r_Nc + ((SIZE, SIZE, n_valid),)
        j_fn = jpred._shear_fn("remap", r_plan, bounds, ch_group=2)
        a, sa = j_fn(jnp.asarray(stack),
                     jnp.zeros(vol_shape + (N_CLASSES,), jnp.float32),
                     jnp.ones((N_CLASSES,), jnp.float32), want_argmax=True)
        b = tpred.shear_remap(stack_bf16, t_plan,
                              t_Nc + ((SIZE, SIZE, n_valid),), group=2)
        assert b.dtype == torch.bfloat16
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a),
                                   atol=2e-2)
        # the JAX side output is nibble-packed along Z
        sa = _unpack_class_map(np.asarray(sa), vol_shape)
        agree = (b.argmax(-1).numpy() == sa).mean()
        assert agree >= 0.98, agree


def test_u8_codes_equal_jax_and_u8_prediction(setup):
    """uint8 staging: codes, step and vmin exactly equal to the JAX
    package's on a bucket-padded two-channel volume with a scaler; the
    dequantised volume within range/510; and a u8-staged prediction close
    to the bf16-staged one."""

    class Scaler:
        def transform(self, x):
            return (x - np.float32(0.3)) / np.float32(1.7)

    rng = np.random.RandomState(3)
    vol = (rng.randn(30, 33, 20, 2) * [1.0, 5.0]).astype(np.float32)
    aff = np.eye(4)
    js = JVolumeSampler(vol, None, aff, 0.0, scaler=Scaler())
    ts = VolumeSampler(vol, aff, 0.0, scaler=Scaler())
    for bucket in (32, 0):
        jq, jstep, jvmin = js._quantized_codes(bucket)
        tq, tstep, tvmin = ts.quantized_codes(bucket)
        assert tq.dtype == np.uint8 and tq.shape == jq.shape
        np.testing.assert_array_equal(tq, jq)
        np.testing.assert_array_equal(tstep, jstep)
        np.testing.assert_array_equal(tvmin, jvmin)
    deq = ts.device_volume_unpacked(CPU, dtype=torch.float32, quantize=True)
    scaled = ts.scaled_volume
    rng_c = scaled.max((0, 1, 2)) - scaled.min((0, 1, 2))
    err = np.abs(deq[:30, :33, :20].numpy() - scaled).max((0, 1, 2))
    assert np.all(err <= rng_c / 510 * (1 + 1e-5)), (err, rng_c / 510)
    np.testing.assert_allclose(deq[30:].numpy(), 0.0, atol=tstep.max() / 2)

    make, _, timg = setup
    _, t16 = make("auto")
    _, tu8 = make("auto", stage_dtype="u8")
    views = jgeo.get_random_views(2, rng=np.random.RandomState(5))
    a, _ = t16.predict_image(timg, views, n_planes="same",
                             return_per_view=False)
    timg.interpolator.unload_device()
    b, _ = tu8.predict_image(timg, views, n_planes="same",
                             return_per_view=False)
    timg.interpolator.unload_device()
    assert (a == b).mean() >= 0.99


def test_eval_counts_equal_jax_and_per_view_maps(setup):
    """The (3, C) confusion counts equal the JAX package's
    `_class_map_counts` exactly, and predict_image(eval_labels=...)
    returns per view the counts of that view's class map."""
    rng = np.random.RandomState(0)
    cls = rng.randint(0, N_CLASSES + 1, (9, 10, 11)).astype(np.uint8)
    lab = rng.randint(0, N_CLASSES, (9, 10, 11)).astype(np.uint8)
    want = np.asarray(j_class_map_counts(jnp.asarray(cls), jnp.asarray(lab),
                                         N_CLASSES, False, (9, 10, 11)))
    got = class_map_counts(torch.from_numpy(cls), torch.from_numpy(lab),
                           N_CLASSES)
    np.testing.assert_array_equal(got.numpy(), want)

    make, _, timg = setup
    _, tpred = make("auto")
    views = jgeo.get_random_views(2, rng=np.random.RandomState(5))
    _, maps = tpred.predict_image(timg, views, n_planes="same")
    labels = rng.randint(0, N_CLASSES, (SIZE,) * 3).astype(np.uint8)
    _, counts = tpred.predict_image(timg, views, n_planes="same",
                                    eval_labels=labels[..., None])
    for m, c in zip(maps, counts):
        assert c.shape == (3, N_CLASSES)
        np.testing.assert_array_equal(
            c, class_map_counts(torch.from_numpy(m), torch.from_numpy(labels),
                                N_CLASSES).numpy())


class OneHotOracle(nn.Module):
    """'Model' returning one_hot(round(input intensity)) - ground truth."""

    def __init__(self, n_classes):
        super().__init__()
        self.n_classes = n_classes

    def forward(self, x):
        cls = torch.clamp(torch.round(x[:, 0].float()), 0, self.n_classes - 1)
        onehot = nn.functional.one_hot(cls.long(), self.n_classes)
        return onehot.permute(0, 3, 1, 2).float()


def _label_volume(size=24):
    lab = np.zeros((size, size, size), np.uint8)
    lab[4:12, 4:12, 4:12] = 1
    lab[14:20, 6:14, 8:16] = 2
    lab[6:10, 14:20, 14:20] = 3
    return lab


@pytest.mark.parametrize("resampler,thresh,thresh_v,sum_atol",
                         [("gather", 0.97, 0.93, 1e-4),
                          ("shear", 0.95, 0.91, 1e-2)])
def test_oracle_reconstructs_labels(resampler, thresh, thresh_v, sum_atol):
    """Feed the label volume as the image through a one-hot oracle: the
    stack -> model -> remap -> fuse pipeline must reconstruct it, with
    the thresholds tests/test_predict_graph.py holds the JAX resamplers
    to."""
    size, nc = 24, 4
    lab = _label_volume(size)
    vol = lab.astype(np.float32)[..., None]
    img = _Image(vol, np.eye(4), VolumeSampler(vol, np.eye(4)))
    pred = MultiViewPredictor(OneHotOracle(nc), sample_dim=size,
                              real_space_span=float(size - 2), n_classes=nc,
                              device=CPU, chunk=4, resampler=resampler)
    views = jgeo.get_random_views(4, rng=np.random.RandomState(3))
    fused, per_view = pred.predict_image(img, views, n_planes="same+20",
                                         return_probs=True)
    assert fused.shape == lab.shape + (nc,)
    np.testing.assert_allclose(fused.sum(-1), 1.0, atol=sum_atol)
    interior = np.zeros_like(lab, bool)
    interior[2:-2, 2:-2, 2:-2] = True
    assert (fused.argmax(-1) == lab)[interior].mean() > thresh
    for pv in per_view:
        assert (pv == lab)[interior].mean() > thresh_v


def _rotated_oracle_affine():
    R = jgeo.rotation_matrix([0, 0, 1], angle_deg=25) @ \
        jgeo.rotation_matrix([1, 0, 0], angle_deg=10)
    affine = np.eye(4)
    affine[:3, :3] = R
    return affine


@pytest.mark.parametrize("case", ["rotated", "flipped", "non_cubic"])
def test_oracle_under_affines(case):
    """The geometry cases of tests/test_predict_graph.py (rotated, LAS
    flipped and non-cubic anisotropic volumes) on the port with the
    default resampler: the oracle reconstruction still holds."""
    if case == "non_cubic":
        lab = np.zeros((24, 36, 28), np.uint8)
        lab[4:12, 8:20, 6:16] = 1
        lab[14:20, 22:32, 16:24] = 2
        affine, nc, dim, span, seed, thresh = (
            np.diag([1.0, 0.8, 1.2, 1.0]), 3, 32, 36.0, 9, 0.9)
    else:
        lab = _label_volume(24)
        affine = (_rotated_oracle_affine() if case == "rotated"
                  else np.diag([-1.0, 1.0, -1.0, 1.0]))
        nc, dim, span, thresh = 4, 24, 22.0, 0.95
        seed = 5 if case == "rotated" else 6
    vol = lab.astype(np.float32)[..., None]
    img = _Image(vol, affine, VolumeSampler(vol, affine))
    if case != "non_cubic":
        assert img.interpolator.rot_mat is not None
    pred = MultiViewPredictor(OneHotOracle(nc), sample_dim=dim,
                              real_space_span=span, n_classes=nc, device=CPU,
                              chunk=4)
    views = jgeo.get_random_views(3, rng=np.random.RandomState(seed))
    fused, _ = pred.predict_image(img, views, n_planes="same+8",
                                  return_per_view=False, return_probs=True)
    assert fused.shape == lab.shape + (nc,)
    interior = np.zeros_like(lab, bool)
    interior[2:-2, 2:-2, 2:-2] = True
    acc = (fused.argmax(-1) == np.minimum(lab, nc - 1))[interior].mean()
    assert acc > thresh, acc


def test_named_errors():
    """A dim the U-Net would crop raises; a view set whose plane stacks
    do not fit the guard raises ValueError under resampler='shear' (the
    JAX package's message) and completes through the gather path under
    'auto'; unknown resampler and staging names raise."""
    with pytest.raises(ValueError, match="divisible"):
        MultiViewPredictor(UNet(n_classes=2, depth=2, init_filters=4),
                           sample_dim=30, real_space_span=30.0, n_classes=2,
                           device=CPU)
    for bad in (dict(resampler="nearest"), dict(stage_dtype="f16")):
        with pytest.raises(ValueError, match="must be"):
            MultiViewPredictor(OneHotOracle(2), sample_dim=16,
                               real_space_span=15.0, n_classes=2, device=CPU,
                               **bad)
    lab = np.zeros((16, 16, 16), np.uint8)
    lab[4:12, 3:10, 5:13] = 1
    vol = lab.astype(np.float32)[..., None]
    img = _Image(vol, np.eye(4), VolumeSampler(vol, np.eye(4)))
    views = jgeo.get_random_views(2, rng=np.random.RandomState(0))
    shear = MultiViewPredictor(OneHotOracle(2), sample_dim=16,
                               real_space_span=15.0, n_classes=2, device=CPU,
                               resampler="shear")
    shear.stage_bytes_max = 1.0  # no plane stack fits
    with pytest.raises(ValueError, match="does not factor"):
        shear.predict_image(img, views)
    auto = MultiViewPredictor(OneHotOracle(2), sample_dim=16,
                              real_space_span=15.0, n_classes=2, device=CPU)
    auto.stage_bytes_max = 1.0
    fused, per_view = auto.predict_image(img, views)
    assert auto.remap_modes == ["gather", "gather"]
    assert fused.shape == lab.shape and len(per_view) == 2
    assert (fused == lab)[2:-2, 2:-2, 2:-2].mean() > 0.95
