"""The port's last public helpers against the JAX package's: the
VolumeSampler host path and its float32 `device_volume`,
`shear_resample_np`, `smooth_field`, `add_noise_to_views` and the
repaired listed-view branch of `load_or_create_views`, the result tables
written by `results_to_csv` / `results_to_txt` and read by
`parse_results`, `save_final_weights`, and the small bases
(`BaseSequence.n_samples`, `Augmenter`, `Callback.on_batch_end`,
`UNet.cf` / `UNet3D.cf`, `FusionModel.init_params`). Seeded numpy
inputs go through both packages; the port runs on the CPU. Each test's
docstring states its tolerance."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multiplanarunet_tpu.augmentation import augmenters as jaug
from multiplanarunet_tpu.bin import summary as jsummary
from multiplanarunet_tpu.callbacks.callbacks import Callback as JCallback
from multiplanarunet_tpu.image.volume_sampler import (
    VolumeSampler as JVolumeSampler,
)
from multiplanarunet_tpu.logging import log_results as jlog
from multiplanarunet_tpu.logging import ScreenLogger as JScreen
from multiplanarunet_tpu.models import checkpoint as jckpt
from multiplanarunet_tpu.models.fusion_model import (
    FusionModel as JFusionModel,
)
from multiplanarunet_tpu.models.unet import UNet as JUNet
from multiplanarunet_tpu.models.unet3d import UNet3D as JUNet3D
from multiplanarunet_tpu.ops import elastic as jelastic
from multiplanarunet_tpu.ops import geometry as jgeo
from multiplanarunet_tpu.ops import shear as jshear
from multiplanarunet_tpu.preprocessing import data_preparation_funcs as jprep
from multiplanarunet_tpu.sequences.base_sequence import (
    BaseSequence as JBaseSequence,
)
from multiplanarunet_tpu_torch.augmentation import augmenters as taug
from multiplanarunet_tpu_torch.bin import summary as tsummary
from multiplanarunet_tpu_torch.bin.train import save_final_weights
from multiplanarunet_tpu_torch.callbacks.callbacks import Callback
from multiplanarunet_tpu_torch.image.volume_sampler import VolumeSampler
from multiplanarunet_tpu_torch.logging import log_results as tlog
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.models.fusion_model import FusionModel
from multiplanarunet_tpu_torch.models.unet import UNet
from multiplanarunet_tpu_torch.models.unet3d import UNet3D
from multiplanarunet_tpu_torch.ops import elastic as telastic
from multiplanarunet_tpu_torch.ops import geometry as tgeo
from multiplanarunet_tpu_torch.ops import shear as tshear
from multiplanarunet_tpu_torch.preprocessing import (
    data_preparation_funcs as tprep,
)
from multiplanarunet_tpu_torch.sequences.base_sequence import BaseSequence
from multiplanarunet_tpu_torch.train.trainer import Trainer
from tests.torch_projects import torch_threads  # noqa: F401


# ------------------------------------------------------ VolumeSampler host
def _affine(kind):
    affine = np.eye(4)
    if kind == "oblique":
        R = tgeo.rotation_matrix([0.2, 0.1, 1], angle_deg=30) @ \
            tgeo.rotation_matrix([1, 0, 0], angle_deg=-12)
        affine[:3, :3] = R @ np.diag([1.0, 1.2, 0.8])
    else:  # flipped axes, one of them scaled
        affine[:3, :3] = np.diag([-1.0, 1.0, -1.3])
    affine[:3, 3] = [4.0, -2.0, 7.0]
    return affine


class _Scale:
    """An affine per-channel scaler (transform only)."""

    def transform(self, x):
        return (np.asarray(x, np.float32) - 0.25) * 3.0


@pytest.mark.parametrize("kind", ["oblique", "flipped"])
def test_volume_sampler_host_path(kind):
    """apply_rotation, intrp_image (the RAW image, linear, bg_value
    outside), intrp_labels (nearest, bg_class outside, uint8) and
    __call__ at a (3, ...) mesh, unit axes squeezed, against the JAX
    sampler: equal values (the same numpy arithmetic); a label above 255
    gives uint16 in both; device_volume is the scaled, bucket-padded
    float32 volume, cached."""
    rng = np.random.RandomState(0)
    image = rng.rand(18, 20, 14, 2).astype(np.float32)
    labels = rng.randint(0, 5, (18, 20, 14)).astype(np.uint8)
    affine = _affine(kind)
    j = JVolumeSampler(image, labels, affine, bg_value=[0.5, -1.0],
                       bg_class=3, scaler=_Scale())
    t = VolumeSampler(image, affine, [0.5, -1.0], _Scale(), labels=labels,
                      bg_class=3)
    mesh = (rng.rand(3, 9, 1, 7) * 30.0 - 15.0).astype(np.float32)
    np.testing.assert_array_equal(t.apply_rotation(mesh),
                                  j.apply_rotation(mesh))
    for apply_rot in (True, False):
        ti = t.intrp_image(mesh, apply_rot=apply_rot)
        np.testing.assert_array_equal(ti, j.intrp_image(mesh, apply_rot))
        tl = t.intrp_labels(mesh, apply_rot=apply_rot)
        np.testing.assert_array_equal(tl, j.intrp_labels(mesh, apply_rot))
        assert ti.shape == (9, 7, 2) and tl.shape == (9, 7)
        assert tl.dtype == np.uint8
    (ti, tl), (ji, jl) = t(mesh), j(mesh)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    assert (tl == 3).any() and (tl != 3).any()
    assert ((ti == [0.5, -1.0]).all(-1)).any()

    big = labels.astype(np.int32) * 100
    tb = VolumeSampler(image, affine, 0.0, labels=big)
    jb = JVolumeSampler(image, big, affine)
    assert tb.intrp_labels(mesh).dtype == jb.intrp_labels(mesh).dtype \
        == np.uint16
    assert VolumeSampler(image, affine).intrp_labels(mesh) is None

    vol = t.device_volume("cpu")
    assert vol.dtype == torch.float32 and tuple(vol.shape) == (32, 32, 32, 2)
    np.testing.assert_array_equal(vol.numpy(), np.asarray(j.device_volume()))
    assert t.device_volume("cpu") is vol
    assert t.device_volume("cpu", dtype=torch.bfloat16).dtype == \
        torch.bfloat16
    t.unload_device()
    assert t._device_volume is None


# ------------------------------------------------------- shear_resample_np
def _random_affine(rng):
    Q, _ = np.linalg.qr(rng.randn(3, 3))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q @ np.diag(1.0 + (rng.rand(3) * 0.8 - 0.3))


def _shear_case(name):
    """(src, N, c, out_shape, fill, method, exact) of the cases of
    tests/test_shear.py."""
    rng = np.random.RandomState(len(name))
    if name == "identity":
        src = rng.rand(12, 14, 10, 2).astype(np.float32)
        return src, np.eye(3), np.zeros(3), src.shape[:3], [9.0, 9.0], \
            "linear", False
    if name == "translation":
        src = rng.rand(10, 10, 10, 1).astype(np.float32)
        return src, np.eye(3), np.array([4.0, 0.0, 0.0]), src.shape[:3], \
            [7.0], "linear", False
    out_shape = (22, 20, 21)
    N = _random_affine(rng)
    c = np.array([9.0, 11.0, 8.0]) - N @ (np.asarray(out_shape) / 2.0)
    g = np.meshgrid(*[np.linspace(0, 3, s) for s in (20, 24, 18)],
                    indexing="ij")
    src = np.stack([np.sin(g[0] + 2 * g[1]) + g[2], np.cos(g[1]) * g[0]],
                   -1).astype(np.float32)
    method = {"random_linear": "linear", "random_nearest": "nearest",
              "random_cubic": "cubic"}.get(name, "linear")
    if name == "affine_field":
        src = (1.5 * g[0] - 0.7 * g[1] + 0.3 * g[2] + 2.0)[..., None]
    return src, N, c, out_shape, np.array([5.5, -5.5])[:src.shape[-1]], \
        method, True


@pytest.mark.parametrize("name", ["identity", "translation", "random_linear",
                                  "random_nearest", "random_cubic",
                                  "affine_field"])
def test_shear_resample_np_matches_jax(name):
    """The port's float64 numpy resample against the JAX package's on the
    cases of tests/test_shear.py, each through its own package's plan:
    within 1e-12. The port's plain torch shear_resample (float32) lies
    within 2e-4 of it, as the JAX executor does of the JAX twin."""
    src, N, c, out_shape, fill, method, exact = _shear_case(name)
    eb = (N, c) if exact else None
    jplan = jshear.plan_affine_resample(N, c, src.shape[:3], out_shape)
    tplan = tshear.plan_affine_resample(N, c, src.shape[:3], out_shape)
    j = jshear.shear_resample_np(src, jplan, fill, method=method,
                                 exact_bounds=eb)
    t = tshear.shear_resample_np(src, tplan, fill, method=method,
                                 exact_bounds=eb)
    assert t.dtype == np.float64 and t.shape == tuple(out_shape) + (
        src.shape[-1],)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-12)
    if method != "nearest":
        tt = tshear.shear_resample(torch.from_numpy(np.asarray(
            src, np.float32)), tplan, np.asarray(fill, np.float32),
            method=method, exact_bounds=eb).numpy()
        np.testing.assert_allclose(tt, t, atol=2e-4)


# ------------------------------------------------------------ smooth_field
@pytest.mark.parametrize("shape,sigma", [((40, 36), 4.0), ((20, 18, 22),
                                                           2.5)])
def test_smooth_field(shape, sigma):
    """One field blurred with a scalar sigma against the JAX smooth_field:
    within 1e-5 (float32 convolutions in different orders)."""
    field = np.random.RandomState(1).uniform(-1, 1, shape).astype(np.float32)
    j = np.asarray(jelastic.smooth_field(jnp.asarray(field), sigma, 12))
    t = telastic.smooth_field(torch.from_numpy(field), sigma, 12).numpy()
    assert t.shape == shape
    np.testing.assert_allclose(t, j, atol=1e-5)


# ------------------------------------------------------------------- views
def test_add_noise_to_views():
    """Equal RandomStates, then numpy's global stream seeded alike:
    bit-equal views, and the streams left equal."""
    views = jgeo.get_random_views(4, rng=np.random.RandomState(2))
    j_rng, t_rng = np.random.RandomState(5), np.random.RandomState(5)
    np.testing.assert_array_equal(tprep.add_noise_to_views(views, 0.2, t_rng),
                                  jprep.add_noise_to_views(views, 0.2, j_rng))
    assert j_rng.rand() == t_rng.rand()
    np.random.seed(8)
    j = jprep.add_noise_to_views(views, 0.1)
    j_next = np.random.rand()
    np.random.seed(8)
    t = tprep.add_noise_to_views(views, 0.1)
    np.testing.assert_array_equal(t, j)
    assert np.random.rand() == j_next
    np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, atol=1e-12)


@pytest.mark.parametrize("style", ["iso_live", "iso_live_3d"])
def test_load_or_create_views_listed(tmp_path, style):
    """Listed views: pre-noised once with fit.noise_sd for an intrp_style
    other than iso_live, which then sets noise_sd False, kept as given for
    iso_live, as the JAX function does from the same global numpy state:
    views bit-equal, views.npz equal; the per-task form (pre_noise=False)
    keeps them as given."""
    listed = [[0.0, 0.0, 1.0], [0.6, 0.8, 0.0], [0.3, -0.2, 0.9]]
    out = {}
    for name, mod, log in (("jax", jprep, JScreen(False)),
                           ("port", tprep, ScreenLogger(False))):
        hparams = {"fit": {"views": listed, "intrp_style": style,
                           "noise_sd": 0.1}}
        base = tmp_path / name
        base.mkdir()
        np.random.seed(4)
        views = mod.load_or_create_views(hparams, False, log, str(base))
        views = hparams["fit"]["views"] if views is None else views
        out[name] = (np.asarray(views), hparams["fit"]["noise_sd"],
                     np.load(base / "views.npz")["arr_0"])
    (jv, jsd, jfile), (tv, tsd, tfile) = out["jax"], out["port"]
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tfile, jfile)
    assert tsd == jsd == (0.1 if style == "iso_live" else False)
    assert np.allclose(tv, listed) == (style == "iso_live")
    hparams = {"fit": {"views": listed, "intrp_style": style,
                       "noise_sd": 0.1}}
    kept = tprep.load_or_create_views(hparams, False, ScreenLogger(False),
                                      str(tmp_path / "port"),
                                      name="views_t", pre_noise=False)
    np.testing.assert_array_equal(kept, np.asarray(listed))
    assert hparams["fit"]["noise_sd"] == 0.1


# ----------------------------------------------------------- result tables
def _filled_tables(mod, views, images):
    """The JAX package's predict tables filled alike in both packages:
    dice values, a tiny value that turns a column scientific, NaN
    holes."""
    results, pc = mod.init_result_dicts(views, images, 4)
    rng = np.random.RandomState(3)
    for i, im in enumerate(sorted(images)):
        for k in [str(v) for v in views] + ["MJ"]:
            if (i + len(k)) % 4:
                v = rng.rand()
                if mod is jlog:
                    results.loc[im, k] = v
                else:
                    results.set(im, k, v)
        for k in [str(v) for v in views] + ["MJ"]:
            for c in range(1, 4):
                v = 1e-9 if (im, c, k) == (images[0], 2, "MJ") else rng.rand()
                if mod is jlog:
                    pc[k].loc[c, im] = v
                else:
                    pc[k].set(c, im, v)
    return results, pc


def test_result_files_match_jax(tmp_path):
    """results_to_csv and results_to_txt write the JAX package's bytes
    for the predict tables (through save_all), a dict with a class column
    and the 3D results transposed; parse_results reads back the same
    labels and values as the JAX parse_results: NaN where NaN, else
    within 1e-15 (Python's float() reads the CSV exactly, pandas' parser
    a last bit off)."""
    views = [np.array([0.1, 0.2, 0.97]), np.array([-0.5, 0.3, 0.81])]
    images = ["img_b", "a", "subject_10"]
    for name, mod in (("jax", jlog), ("port", tlog)):
        results, pc = _filled_tables(mod, views, images)
        (tmp_path / name).mkdir()
        mod.save_all(results, pc, str(tmp_path / name))
        d3, detailed = mod.init_result_dict_3D(images, 3)
        detailed = {"class": [1, 2], "a": [0.5, 0.25], "img_b": [1.0, 0.0],
                    "subject_10": [np.nan, 0.125]}
        d3 = {"a": [0.75], "img_b": [np.nan], "subject_10": [0.5]}
        for fname, table, tr in (("r3", d3, True), ("det", detailed, False)):
            mod.results_to_csv(table, str(tmp_path / name), fname, tr)
            mod.results_to_txt(table, str(tmp_path / name), fname, tr)
    jfiles = sorted(p.relative_to(tmp_path / "jax")
                    for p in (tmp_path / "jax").rglob("*.*"))
    tfiles = sorted(p.relative_to(tmp_path / "port")
                    for p in (tmp_path / "port").rglob("*.*"))
    assert tfiles == jfiles and len(jfiles) == 12
    for rel in jfiles:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel
    jr, jpc = jsummary.parse_results(str(tmp_path / "jax" / "csv"))
    tr, tpc = tsummary.parse_results(str(tmp_path / "port" / "csv"))
    assert sorted(tpc) == sorted(jpc) and "MJ" in tpc
    for t, j in [(tr, jr)] + [(tpc[k], jpc[k]) for k in jpc]:
        assert [str(i) for i in t.index] == [str(i) for i in j.index]
        assert [str(c) for c in t.columns] == [str(c) for c in j.columns]
        np.testing.assert_allclose(t.values, j.to_numpy(np.float64),
                                   rtol=0, atol=1e-15)
    csv_dir = str(tmp_path / "port" / "csv")
    assert tsummary.build_report([csv_dir]) == \
        jsummary.build_report([csv_dir])


# -------------------------------------------------------------- final save
def test_save_final_weights(tmp_path):
    """save_final_weights writes model/model_weights.npz that the JAX
    package's load_weights reads, every kernel equal to the port model's
    (HWIO of OIHW) and the logger told the path."""
    model = UNet(n_classes=3, depth=2, init_filters=4)
    trainer = Trainer(model, logger=ScreenLogger(False), device="cpu")
    (tmp_path / "model").mkdir()
    said = []
    save_final_weights(trainer, tmp_path, logger=said.append)
    path = tmp_path / "model" / "model_weights.npz"
    assert said == [f"Saving current model to: {path}"]
    params, stats, _ = jckpt.load_weights(path)
    k = model.encoder_L0.conv1.weight.detach().numpy()
    np.testing.assert_array_equal(
        params["encoder_L0"]["conv1"]["kernel"], k.transpose(2, 3, 1, 0))
    assert "out_conv" in params and stats


# ------------------------------------------------------------- small bases
def test_small_bases():
    """n_samples is len() (10^12) in both; Augmenter is the base of the
    elastic augmenters and raises NotImplementedError when called;
    Callback.on_batch_end is a no-op; UNet.cf and UNet3D.cf equal the
    flax modules' sqrt(complexity_factor); FusionModel.init_params is the
    JAX params tree (ones and zeros) as numpy, count_params alike."""
    assert BaseSequence().n_samples == JBaseSequence().n_samples == int(1e12)
    assert issubclass(taug.Elastic2D, taug.Augmenter)
    assert issubclass(taug.Elastic3D, taug.Augmenter)
    for base in (taug.Augmenter(), jaug.Augmenter()):
        with pytest.raises(NotImplementedError):
            base(None, None)
    assert Callback().on_batch_end(3, {"loss": 1.0}) is None
    assert JCallback().on_batch_end(3, {"loss": 1.0}) is None
    for cf in (2, 0.5, 1.0):
        assert UNet(3, depth=1, complexity_factor=cf).cf == \
            JUNet(n_classes=3, complexity_factor=cf).cf
        assert UNet3D(3, depth=1, complexity_factor=cf).cf == \
            JUNet3D(n_classes=3, complexity_factor=cf).cf
    jparams = JFusionModel(n_inputs=3, n_classes=5).init_params()
    tparams = FusionModel(3, 5).init_params(rng=123)
    for leaf in ("W", "b"):
        np.testing.assert_array_equal(tparams["fusion"][leaf],
                                      np.asarray(jparams["fusion"][leaf]))
        assert tparams["fusion"][leaf].dtype == np.float32
    assert FusionModel(3, 5).count_params(tparams) == \
        JFusionModel(n_inputs=3, n_classes=5).count_params(jparams) == \
        FusionModel(3, 5).count_params() == 20
