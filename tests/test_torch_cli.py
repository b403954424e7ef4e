"""The port's `mp predict` host layer against the JAX package: NIfTI IO,
the YAML reader and hparams, the scalers, the result CSVs, the model
build (incl. non-default kernel sizes and activations), and `mp predict`
end to end on a tiny project run by both packages' entry points."""
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from multiplanarunet_tpu.bin import init_project as j_init_project
from multiplanarunet_tpu.bin import predict as j_predict
from multiplanarunet_tpu.bin import summary as j_summary
from multiplanarunet_tpu.hyperparameters import YAMLHParams as JYAMLHParams
from multiplanarunet_tpu.image.auditor import Auditor
from multiplanarunet_tpu.io import nifti as jnifti
from multiplanarunet_tpu.logging import log_results as jlr
from multiplanarunet_tpu.models import checkpoint as jckpt
from multiplanarunet_tpu.models.unet import UNet as JUNet
from multiplanarunet_tpu.ops import geometry as jgeo
from multiplanarunet_tpu_torch import _device
from multiplanarunet_tpu_torch.bin import mp as t_mp
from multiplanarunet_tpu_torch.bin import predict as t_predict
from multiplanarunet_tpu_torch.hyperparameters.hparams import YAMLHParams
from multiplanarunet_tpu_torch.hyperparameters.yaml_reader import (
    YAMLSubsetError,
    safe_load,
)
from multiplanarunet_tpu_torch.io import nifti as tnifti
from multiplanarunet_tpu_torch.logging import log_results as tlr
from multiplanarunet_tpu_torch.models.model_init import (
    UnsupportedModelError,
    build_model,
    load_unet_weights,
)
from multiplanarunet_tpu_torch.models.unet import UnsupportedActivationError
from multiplanarunet_tpu_torch.preprocessing.scaling import (
    NoOpScaler,
    UnsupportedScalerError,
    get_scaler,
)
from tests.torch_projects import (  # noqa: F401
    edit_yaml,
    flax_init,
    preset_yaml,
    run_jax_entry,
    torch_threads,
)


REPO = Path(__file__).resolve().parents[1]
DEFAULTS = sorted((REPO / "multiplanarunet_tpu" / "bin" / "defaults")
                  .glob("*/train_hparams.yaml"))


# ---------------------------------------------------------------- NIfTI IO
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int16])
def test_nifti_each_package_reads_the_other(tmp_path, suffix, dtype):
    rng = np.random.RandomState(0)
    arr = (rng.rand(7, 6, 5) * 100).astype(dtype)
    affine = np.array([[0.9, 0.1, 0, -3.0], [0, 1.1, 0.05, 2.0],
                       [0, 0, 1.2, 0.5], [0, 0, 0, 1]])
    for writer, reader, name in ((jnifti, tnifti, "j"), (tnifti, jnifti, "t")):
        path = tmp_path / f"{name}{suffix}"
        writer.save(arr, path, affine=affine)
        img = reader.load(path)
        assert img.shape == arr.shape
        assert img.get_data_dtype() == np.dtype(dtype)
        np.testing.assert_array_equal(img.get_raw_data(), arr)
        np.testing.assert_array_equal(img.affine, writer.load(path).affine)
        np.testing.assert_array_equal(img.get_fdata(), arr.astype(np.float32))
    assert (tmp_path / f"j{suffix}").read_bytes() == \
        (tmp_path / f"t{suffix}").read_bytes() or suffix == ".nii.gz"


# ------------------------------------------------------------------- YAML
def _init_project_yaml(tmp_path):
    """A train_hparams.yaml as `mp init_project` writes it, with the
    Auditor's values filled in over a two-image dataset."""
    data = tmp_path / "data"
    rng = np.random.RandomState(1)
    for split in ("train", "val", "test"):
        for sub in ("images", "labels"):
            (data / split / sub).mkdir(parents=True)
        for k in range(2):
            img = rng.rand(20, 22, 18).astype(np.float32)
            aff = np.diag([1.0, 1.25, 0.9, 1.0])
            jnifti.save(img, data / split / "images" / f"s{k}.nii.gz", aff)
            jnifti.save((img * 3).astype(np.uint8),
                        data / split / "labels" / f"s{k}.nii.gz", aff)
    j_init_project.entry_func(["--name", "proj", "--root", str(tmp_path),
                               "--data_dir", str(data)])
    path = tmp_path / "proj" / "train_hparams.yaml"
    hp = JYAMLHParams(path, no_log=True, no_version_control=True)
    imgs = sorted((data / "train" / "images").glob("*.nii.gz"))
    labs = sorted((data / "train" / "labels").glob("*.nii.gz"))
    Auditor(imgs, labs, hparams=hp).fill(hp, "2d")
    return path


@pytest.mark.parametrize("which", [p.parent.name for p in DEFAULTS]
                         + ["init_project+Auditor"])
def test_yaml_reader_equals_pyyaml(tmp_path, which):
    path = (_init_project_yaml(tmp_path) if which == "init_project+Auditor"
            else next(p for p in DEFAULTS if p.parent.name == which))
    text = path.read_text()
    assert safe_load(text) == yaml.safe_load(text)
    port = YAMLHParams(path, no_log=True, no_version_control=True)
    ref = JYAMLHParams(path, no_log=True, no_version_control=True)
    assert dict(port) == dict(ref)
    assert port.groups == ref.groups
    for key in ("bg_value", "scaler", "n_classes", "dim", "missing"):
        assert port.get_from_anywhere(key) == ref.get_from_anywhere(key)
    assert port.get_group("build") == ref.get_group("build")


def test_yaml_reader_scalars_and_errors():
    text = ("a: [0x1F, 0b101, 012, 1_000, 1:30, 1.5e-3, 1e-5, .5, 1pct]\n"
            "b: {t: yes, f: Off, n: ~, e: , s: 'it''s', d: \"x\\ty\"}\n"
            "c:\n- &A {k: [1, 2]}\n- *A\n- - 3\n  - x: 4\n    y: -0.0\n"
            "'q k': it's  # comment\n")
    assert safe_load(text) == yaml.safe_load(text)
    for bad in ("a: |\n  text\n", "a: 2001-12-14\n", "<<: {a: 1}\n",
                "a: 1\n  b: 2\n"):
        with pytest.raises(YAMLSubsetError):
            safe_load(bad)


# ---------------------------------------------------------------- scalers
@pytest.mark.parametrize("name", ["StandardScaler", "MinMaxScaler",
                                  "MaxAbsScaler", "RobustScaler"])
@pytest.mark.parametrize("ignore", [None, [9.0, -2.5]])
def test_scalers_match_sklearn(name, ignore):
    import sklearn.preprocessing as skl

    rng = np.random.RandomState(0)
    X = (rng.randn(14, 15, 13, 2) * [3, 0.5] + [10, -2]).astype(np.float32)
    scaler = get_scaler(name, ignore_less_eq=ignore).fit(X)
    center, scale = scaler.affine_params()
    for c in range(2):
        xc = X[..., c]
        if ignore is not None:
            xc = xc[xc > ignore[c]]
        ref = getattr(skl, name)().fit(xc.reshape(-1, 1))
        want = ref.transform(np.array([[0.0], [1.0]], np.float32))[:, 0]
        # x -> (x - center) / scale at x = 0 and x = 1
        got = (np.array([0.0, 1.0]) - center[c]) / scale[c]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(scaler.transform(X),
                               (X - center) / scale, rtol=1e-6)


def test_unsupported_scaler_and_noop():
    # One output column per category: neither package can fit it on a
    # volume
    from multiplanarunet_tpu.preprocessing.scaling import (
        get_scaler as j_get_scaler,
    )

    with pytest.raises(UnsupportedScalerError, match="OneHotEncoder"):
        get_scaler("OneHotEncoder")
    with pytest.raises(ValueError):
        j_get_scaler("OneHotEncoder").fit_transform(
            np.arange(8, dtype=np.float32).reshape(2, 2, 2, 1))
    X = np.ones((3, 3, 3, 2), np.float32)
    noop = NoOpScaler().fit(X)
    assert noop.transform(X) is X
    c, s = noop.affine_params()
    assert c.tolist() == [0, 0] and s.tolist() == [1, 1]


# ------------------------------------------------------------ result CSVs
def _fill_tables(lr, views, ids, seed):
    rng = np.random.RandomState(seed)
    results, pc = lr.init_result_dicts(views, ids, 3)
    for k, image_id in enumerate(ids[:-1]):  # the last image stays NaN
        for view in views:
            dices = rng.rand(2).astype(np.float32)
            dices[k % 2] = np.nan if k else dices[k % 2]
            if lr is jlr:
                pc[str(view)][image_id] = dices
                results.loc[image_id, str(view)] = np.nanmean(dices)
            else:
                pc[str(view)].set_column(image_id, dices)
                results.set(image_id, str(view), np.nanmean(dices))
    return results, pc


def test_result_csvs_round_trip_between_packages(tmp_path):
    views = jgeo.get_random_views(2, rng=np.random.RandomState(0))
    ids = ["img_a", "img_b", "img_c"]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    t_res, t_pc = _fill_tables(tlr, views, ids, 0)
    tlr.save_all(t_res, t_pc, tmp_path / "t")
    j_res, j_pc = _fill_tables(jlr, views, ids, 0)
    jlr.save_all(j_res, j_pc, tmp_path / "j")
    assert (sorted(os.listdir(tmp_path / "t" / "csv"))
            == sorted(os.listdir(tmp_path / "j" / "csv")))
    assert (sorted(os.listdir(tmp_path / "t" / "txt"))
            == sorted(os.listdir(tmp_path / "j" / "txt")))
    # JAX reads the port's files; the port reads JAX's (pandas' float
    # parser may differ from Python's in the last bit)
    jr, jp = jlr.load_result_dicts(tmp_path / "t" / "csv", views)
    tr, tp = tlr.load_result_dicts(tmp_path / "j" / "csv", views)
    for key in jp:
        np.testing.assert_allclose(jp[key].to_numpy(), tp[key].values,
                                   rtol=1e-15)
        assert list(jp[key].columns) == tp[key].columns
        assert list(jp[key].index) == tp[key].index
    np.testing.assert_allclose(jr.to_numpy(), tr.values, rtol=1e-15)
    assert list(jr.index) == tr.index and list(jr.columns) == tr.columns
    # Byte-identical CSVs
    for f in os.listdir(tmp_path / "t" / "csv"):
        assert ((tmp_path / "t" / "csv" / f).read_text()
                == (tmp_path / "j" / "csv" / f).read_text()), f
    report = j_summary.build_report([str(tmp_path / "t" / "csv")])
    assert "Per-view mean dice" in report


# ------------------------------------------------------------ model build
def _jax_unet_checkpoint(path, seed=0, sharpen=1.0, **kw):
    model = JUNet(dim=16, **kw)
    v = flax_init(model, jax.random.PRNGKey(seed),
                  (1, 16, 16, kw.get("n_channels", 1)))
    params = jax.tree.map(np.asarray, v["params"])
    params["out_conv"]["kernel"] = params["out_conv"]["kernel"] * sharpen
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    jckpt.save_weights(path, params, stats)
    return model, {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("extra", [
    {"kernel_size": 5}, {"activation": "elu"},
    {"activation": "gelu", "out_activation": "sigmoid"},
    {"activation": "mish"}, {"out_activation": "log_softmax"},
    {"padding": "valid"}, {"flatten_output": True},
])
def test_build_model_honours_unet_fields(tmp_path, extra):
    """A UNet whose build group sets a non-default kernel size,
    activation, padding (the JAX UNet stores it and pads SAME) or
    flatten_output computes what the JAX UNet computes on the same
    weights (within 1e-5)."""
    kw = dict(n_classes=3, n_channels=2, depth=2, init_filters=8, **extra)
    jmodel, variables = _jax_unet_checkpoint(tmp_path / "w.npz", **kw)
    build = dict(model_class_name="UNet", dim=16, complexity_factor=1,
                 biased_output_layer=True, l2_reg=False, **kw)
    model = load_unet_weights(build_model(build), tmp_path / "w.npz")
    x = np.random.RandomState(1).randn(2, 16, 16, 2).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    if not extra.get("flatten_output"):
        got = got.permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    mixed = build_model(build, mixed_precision=True)
    assert mixed.dtype == torch.bfloat16


def test_build_model_named_errors():
    """A model class or an activation name that neither package has: the
    port raises its named error, the JAX package fails too."""
    from multiplanarunet_tpu.models.model_init import (
        build_model as j_build_model,
    )

    base = dict(model_class_name="UNet", n_classes=2, dim=16, depth=2)
    for bad, err in ((dict(model_class_name="NoSuchUNet"),
                      UnsupportedModelError),
                     (dict(activation="no_such_activation"),
                      UnsupportedActivationError),
                     (dict(out_activation="no_such_activation"),
                      UnsupportedActivationError)):
        with pytest.raises(err):
            build_model({**base, **bad})
        # traced, not run: the names are looked up while the init traces
        with pytest.raises((ValueError, AttributeError)):
            jax.eval_shape(lambda: j_build_model({**base, **bad}).init(
                jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1))))
    # the 3D model builds from the same group
    assert build_model({**base, "model_class_name": "UNet3D"}).ndim == 3


def test_mp_dispatch_and_device_errors(tmp_path, monkeypatch):
    # an unknown script is argparse's exit 2, as in the JAX dispatcher
    with pytest.raises(SystemExit) as exit_info:
        t_mp.entry_func(["no_such_script", "--folder", str(tmp_path)])
    assert exit_info.value.code == 2
    # more cards asked for than visible: a named error before any work
    with pytest.raises(_device.TooFewDevicesError,
                       match="2 devices asked, 0 visible"):
        t_mp.entry_func(["predict", "--num_devices", "2"])
    # The default device is CUDA: with no card visible it raises, and never
    # turns into the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(_device.CudaUnavailableError):
        t_mp.entry_func(["predict", "--project_dir", str(tmp_path)])


# ------------------------------------------------------- mp predict, e2e
N_CLASSES = 3
SHAPE = (30, 28, 26)
AFFINE = np.diag([1.0, 1.1, 0.9, 1.0])


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """A tiny project in the JAX package's layout: two test images with
    labels, hparams from the MultiPlanar preset, 3 views, random
    JAX-initialised UNet weights (glorot, out conv sharpened), fusion
    weights; plus the JAX `mp predict` result with learned fusion."""
    root = tmp_path_factory.mktemp("mp_predict")
    rng = np.random.RandomState(0)
    from scipy import ndimage

    for sub in ("images", "labels"):
        (root / "data" / "test" / sub).mkdir(parents=True)
    for name in ("case_a", "case_b"):
        vol = ndimage.gaussian_filter(rng.randn(*SHAPE), 3.0)
        vol = (100 + 40 * vol / vol.std()).astype(np.float32)
        lab = np.digitize(vol, np.percentile(vol, [45, 75])).astype(np.uint8)
        jnifti.save(vol, root / "data" / "test" / "images" / f"{name}.nii.gz",
                    AFFINE)
        jnifti.save(lab, root / "data" / "test" / "labels" / f"{name}.nii.gz",
                    AFFINE)
    proj = root / "proj"
    (proj / "model" / "fusion_weights").mkdir(parents=True)
    shutil.copyfile(preset_yaml("MultiPlanar"), proj / "train_hparams.yaml")
    edit_yaml(proj / "train_hparams.yaml", (
        ("test_data: &TESTDATA\n  base_dir: Null",
         f"test_data: &TESTDATA\n  base_dir: {root / 'data' / 'test'}"),
        ("n_classes: Null", f"n_classes: {N_CLASSES}"),
        ("n_channels: Null", "n_channels: 1"),
        ("dim: Null", "dim: 32\n  init_filters: 8"),
        ("depth: 4", "depth: 2"),
        ("complexity_factor: 2", "complexity_factor: 1"),
        ("real_space_span: Null", "real_space_span: 31"),
        ("mixed_precision: True", "mixed_precision: False")))
    views = jgeo.sample_random_views_with_angle_restriction(
        3, 60, rng=np.random.RandomState(3))
    np.savez(proj / "views.npz", views)
    _jax_unet_checkpoint(proj / "model" / "@epoch_02_val_dice_0.50000.npz",
                         seed=2, sharpen=12.0, n_classes=N_CLASSES,
                         n_channels=1, depth=2, init_filters=8)
    rngw = np.random.RandomState(4)
    jckpt.save_weights(
        proj / "model" / "fusion_weights" / "w_fusion_weights.npz",
        {"fusion": {
            "W": (1.0 + 0.3 * rngw.rand(3, N_CLASSES)).astype(np.float32),
            "b": (0.2 * rngw.randn(1, N_CLASSES)).astype(np.float32)}})
    run_jax(proj, "jax_learned")
    return proj


def run_jax(proj, out, *extra):
    run_jax_entry(j_predict.entry_func, "--project_dir", str(proj),
                  "--out_dir", out, "--overwrite", "--num_devices", "1",
                  *extra)


def run_port(proj, out, *extra):
    return t_mp.entry_func(["predict", "--project_dir", str(proj),
                            "--out_dir", out, "--device", "cpu", *extra])


def _pred(proj, out, case):
    img = tnifti.load(proj / out / "nii_files" / case / "PRED.nii.gz")
    return img.get_raw_data()


def _compare(proj, port_out, jax_out, cases=("case_a", "case_b"),
             dice=True):
    """PRED maps agree >= 0.99 with the JAX run's; with dice, the port's
    result tables (read by the JAX package's reader) hold finite per-view
    and MJ dice within 0.02 of the JAX run's for these cases."""
    for case in cases:
        a, b = _pred(proj, port_out, case), _pred(proj, jax_out, case)
        assert a.dtype == np.uint8 and a.shape == SHAPE and a.max() < 3
        assert (a == b).mean() >= 0.99, case
    if dice:
        views = np.load(proj / "views.npz")["arr_0"]
        jr, jp = jlr.load_result_dicts(proj / jax_out / "csv", views)
        tr, tp = jlr.load_result_dicts(proj / port_out / "csv", views)
        cases = list(cases)
        assert sorted(tr.index) == cases
        assert np.isfinite(tr.loc[cases].to_numpy()).all()
        np.testing.assert_allclose(tr.loc[cases].to_numpy(),
                                   jr.loc[cases].to_numpy(), atol=0.02)
        for key in jp:
            np.testing.assert_allclose(tp[key][cases].to_numpy(),
                                       jp[key][cases].to_numpy(), atol=0.02)


def test_mp_predict_learned_fusion_matches_jax(project):
    timings = run_port(project, "port_learned")
    assert set(timings) == {"case_a", "case_b"}
    assert all({"load", "predict", "save"} <= set(t) for t in
               timings.values())
    _compare(project, "port_learned", "jax_learned")
    log = (project / "port_learned" / "predict_log.txt").read_text()
    assert "Loaded fusion weights" in log


def test_mp_predict_sum_fusion_matches_jax(project):
    run_jax(project, "jax_sum", "--sum_fusion")
    run_port(project, "port_sum", "--sum_fusion", "--save_input_files")
    _compare(project, "port_sum", "jax_sum")
    img = tnifti.load(project / "port_sum" / "nii_files" / "case_a" /
                      "IMAGE.nii.gz")
    assert img.shape == SHAPE


def test_mp_predict_single_file_and_u8(project):
    data = Path(safe_load((project / "train_hparams.yaml").read_text())
                ["test_data"]["base_dir"])
    run_port(project, "port_single", "-f",
             str(data / "images" / "case_b.nii.gz"), "-l",
             str(data / "labels" / "case_b.nii.gz"))
    _compare(project, "port_single", "jax_learned", cases=("case_b",))
    run_port(project, "port_u8", "--stage_dtype", "u8")
    _compare(project, "port_u8", "jax_learned")


def test_mp_predict_no_fuse_views(project):
    """The JAX package's --no_fuse_views parses and changes nothing: the
    same files with the same class maps and result tables as a run
    without it, and one log line saying the views go one at a time."""
    run_port(project, "port_fused")
    run_port(project, "port_no_fuse", "--no_fuse_views")

    def files(out):
        return sorted(p.relative_to(project / out)
                      for p in (project / out).rglob("*") if p.is_file())

    assert files("port_no_fuse") == files("port_fused")
    for case in ("case_a", "case_b"):
        np.testing.assert_array_equal(_pred(project, "port_no_fuse", case),
                                      _pred(project, "port_fused", case))
    for table in (project / "port_fused" / "csv").iterdir():
        assert (project / "port_no_fuse" / "csv" / table.name
                ).read_text() == table.read_text()
    _compare(project, "port_no_fuse", "jax_learned")
    log = (project / "port_no_fuse" / "predict_log.txt").read_text()
    assert log.count("one at a time") == 1
    assert "one at a time" not in (
        project / "port_fused" / "predict_log.txt").read_text()


def test_mp_predict_continue(project):
    """--continue skips the images already in nii_files and updates the
    reloaded result tables; without it an existing out_dir raises."""
    run_port(project, "port_cont", "--no_eval")
    assert not (project / "port_cont" / "csv").exists()
    with pytest.raises(RuntimeError, match="exists"):
        run_port(project, "port_cont", "--no_eval")
    run_port(project, "port_cont", "--no_eval", "--continue")
    log = (project / "port_cont" / "predict_log.txt").read_text()
    assert log.count("Skipping") == 2
    # An evaluated run cut short after its first image, then resumed
    run_port(project, "port_resume")
    shutil.rmtree(project / "port_resume" / "nii_files" / "case_b")
    timings = run_port(project, "port_resume", "--continue")
    assert set(timings) == {"case_b"}
    log = (project / "port_resume" / "predict_log.txt").read_text()
    assert log.count("Skipping") == 1
    _compare(project, "port_resume", "jax_learned")
