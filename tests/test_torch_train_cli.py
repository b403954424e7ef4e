"""`mp train` of the PyTorch port on the CPU (`--device cpu`), end to end
on a tiny NIfTI project (2 epochs of 3 steps), against the JAX package's
`mp train` on a copy of the same project: the same logs/training.csv
columns, the same YAML fields written back (the Auditor's values), the
same checkpoint files; then --continue_training resumes the epoch and the
learning rate, the port's `mp predict` runs on the trained project, and
the named errors."""
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from multiplanarunet_tpu.bin import train as j_train
from multiplanarunet_tpu.bin.toy_data import create_dataset
from multiplanarunet_tpu.models import checkpoint as jckpt
from multiplanarunet_tpu_torch import _device
from multiplanarunet_tpu_torch.bin import mp as t_mp
from multiplanarunet_tpu_torch.callbacks.funcs import CallbackNotPortedError
from multiplanarunet_tpu_torch.io import nifti
from multiplanarunet_tpu_torch.models.model_init import UnsupportedModelError
from multiplanarunet_tpu_torch.preprocessing.scaling import (
    UnsupportedScalerError,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
DEFAULT_YAML = (REPO / "multiplanarunet_tpu" / "bin" / "defaults" /
                "MultiPlanar" / "train_hparams.yaml")
ARGS = ["--overwrite", "--no_images", "--epochs", "2",
        "--train_images_per_epoch", "12", "--val_images_per_epoch", "8"]
# YAML lines both packages stamp with their version and git state
STAMPS = ("__VERSION__", "__BRANCH__", "__COMMIT__")


def _write_project(root, name, extra=()):
    text = DEFAULT_YAML.read_text()
    for old, new in (
            ("train_data: &TRAINDATA\n  base_dir: Null",
             f"train_data: &TRAINDATA\n  base_dir: {root / 'data' / 'train'}"),
            ("val_data: &VALDATA\n  base_dir: Null",
             f"val_data: &VALDATA\n  base_dir: {root / 'data' / 'val'}"),
            ("test_data: &TESTDATA\n  base_dir: Null",
             f"test_data: &TESTDATA\n  base_dir: {root / 'data' / 'val'}"),
            ("dim: Null", "dim: 32\n  init_filters: 8"),
            ("depth: 4", "depth: 2"),
            ("complexity_factor: 2", "complexity_factor: 1"),
            ("views: 6", "views: 3"),
            ("batch_size: 16", "batch_size: 4"),
            ("mixed_precision: True", "mixed_precision: False"),
            *extra):
        assert old in text, old
        text = text.replace(old, new)
    proj = root / name
    proj.mkdir()
    (proj / "train_hparams.yaml").write_text(text)
    return proj


def _run(entry, *args):
    cwd = os.getcwd()
    try:
        return entry(list(args))
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp_train")
    rng = np.random.RandomState(3)
    create_dataset(root / "data" / "train", 3, 32, 1, rng, "train")
    create_dataset(root / "data" / "val", 2, 32, 1, rng, "val")
    port = _write_project(root, "port")
    jax_proj = _write_project(root, "jax")
    _run(t_mp.entry_func, "train", "--project_dir", str(port), "--device",
         "cpu", *ARGS)
    _run(j_train.entry_func, "--project_dir", str(jax_proj),
         "--num_devices", "1", *ARGS)
    return root, port, jax_proj


def _csv(proj):
    lines = (proj / "logs" / "training.csv").read_text().splitlines()
    header = lines[0].split(",")
    return header, [dict(zip(header, r.split(","))) for r in lines[1:]]


def test_csv_yaml_and_files_match_jax(trained):
    _, port, jax_proj = trained
    p_head, p_rows = _csv(port)
    j_head, j_rows = _csv(jax_proj)
    assert p_head == j_head
    assert [r["epoch"] for r in p_rows] == ["0", "1"]
    for row in p_rows:
        for key in ("loss", "val_loss", "val_dice", "lr",
                    "sparse_categorical_accuracy"):
            assert np.isfinite(float(row[key])), key
    assert [r["lr"] for r in p_rows] == [r["lr"] for r in j_rows] == \
        ["5e-05"] * 2
    p_yaml = yaml.safe_load((port / "train_hparams.yaml").read_text())
    j_yaml = yaml.safe_load((jax_proj / "train_hparams.yaml").read_text())
    # both packages stamp their version and this checkout's git state
    assert p_yaml["__VERSION__"] == j_yaml["__VERSION__"] == "0.1.0"
    for key in STAMPS:
        assert p_yaml[key] == j_yaml[key], key
    for group in ("train_data", "val_data", "test_data"):
        p_yaml.pop(group), j_yaml.pop(group)  # per-project paths
    assert p_yaml == j_yaml
    assert p_yaml["build"]["n_classes"] == 4
    assert p_yaml["fit"]["real_space_span"] is not None
    # the port keeps every comment and anchor of the file
    p_text = (port / "train_hparams.yaml").read_text()
    assert p_text.count("#") == DEFAULT_YAML.read_text().count("#")
    views = np.load(port / "views.npz")["arr_0"]
    assert views.shape == (3, 3)
    np.testing.assert_allclose(np.linalg.norm(views, axis=1), 1.0)
    p_models = sorted(p.name.split("_val")[0] for p in
                      (port / "model").glob("*.npz"))
    assert "model_weights.npz" in p_models
    assert any(m.startswith("@epoch_") for m in p_models)
    # the port's weight files hold the JAX package's keys and shapes
    for name in ("model_weights.npz",):
        pp, ps, _ = jckpt.load_weights(port / "model" / name)
        jp, js, _ = jckpt.load_weights(jax_proj / "model" / name)
        shapes = lambda t: {k: np.shape(v) for k, v in  # noqa: E731
                            _flat(t).items()}
        assert shapes(pp) == shapes(jp) and shapes(ps) == shapes(js)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_continue_training_resumes_epoch_and_lr(trained):
    root, port, _ = trained
    proj = root / "port_continue"
    shutil.copytree(port, proj)
    last = max(int(p.name.split("_")[1]) for p in
               (proj / "model").glob("@epoch_*.npz"))
    # a learning rate of the resumed epoch that only the CSV knows
    csv_path = proj / "logs" / "training.csv"
    head, rows = _csv(proj)
    rows[last - 1]["lr"] = "3e-05"
    csv_path.write_text("\n".join([",".join(head)] + [
        ",".join(r[h] for h in head) for r in rows]) + "\n")
    _run(t_mp.entry_func, "train", "--project_dir", str(proj), "--device",
         "cpu", "--continue_training", "--no_images", "--epochs", "3",
         "--train_images_per_epoch", "8", "--val_images_per_epoch", "4")
    _, new_rows = _csv(proj)
    assert [int(r["epoch"]) for r in new_rows] == list(range(3))
    assert new_rows[last]["lr"] == "3e-05"
    log = (proj / "logs" / "train.txt").read_text()
    assert "Restored learning rate: 3e-05" in log
    assert f"epoch={last}" in log


def test_predict_on_the_trained_project(trained):
    _, port, _ = trained
    _run(t_mp.entry_func, "predict", "--project_dir", str(port),
         "--out_dir", "pred", "--device", "cpu", "--no_eval", "--overwrite")
    preds = sorted((port / "pred" / "nii_files").glob("*/PRED.nii.gz"))
    assert len(preds) == 2
    pred = nifti.load(preds[0]).get_raw_data()
    assert pred.shape == (32, 32, 32) and pred.max() < 4


def test_named_errors(trained, tmp_path, monkeypatch):
    root, _, _ = trained
    cases = [
        (["--num_devices", "2", "--device", "cuda"],
         _device.TooFewDevicesError),
        (["--continue_training", "--overwrite"], ValueError),
    ]
    for extra, err in cases:
        with pytest.raises(err):
            _run(t_mp.entry_func, "train", "--project_dir", str(tmp_path),
                 "--device", "cpu", *extra)
    with pytest.raises(RuntimeError, match="not a valid project"):
        _run(t_mp.entry_func, "train", "--project_dir", str(tmp_path),
             "--device", "cpu")
    for name, extra, err in (
            ("unknown_model", [('model_class_name: "UNet"',
                                'model_class_name: "NoSuchUNet"')],
             UnsupportedModelError),
            # neither package can fit PolynomialFeatures on a volume
            ("polynomial", [('scaler: "RobustScaler"',
                             'scaler: "PolynomialFeatures"')],
             UnsupportedScalerError),
            # the JAX package's losses fail on a flattened output too
            ("flatten", [("depth: 2", "depth: 2\n  flatten_output: True")],
             ValueError),
            ("callback", [("callbacks: [*RLOP,",
                           "callbacks: [{class_name: NoSuchCallback}, "
                           "*RLOP,")],
             CallbackNotPortedError)):
        proj = _write_project(root, name, extra)
        with pytest.raises(err):
            _run(t_mp.entry_func, "train", "--project_dir", str(proj),
                 "--device", "cpu", *ARGS)
    # the default device is CUDA: with no card visible it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(_device.CudaUnavailableError):
        _run(t_mp.entry_func, "train", "--project_dir", str(tmp_path))


def test_max_loaded_images_trains_in_both_packages(trained):
    """`mp train --max_loaded_images 2 --num_access 3` on the 3-image
    project: both packages train over a LimitationQueue (per-image
    sampling, the pool's 2 slots being below the batch of 4) and write
    their CSV rows; the port logs its reloads."""
    root, _, _ = trained
    extra = ("--max_loaded_images", "2", "--num_access", "3")
    port = _write_project(root, "port_bounded")
    jax_proj = _write_project(root, "jax_bounded")
    _run(t_mp.entry_func, "train", "--project_dir", str(port), "--device",
         "cpu", *ARGS, *extra)
    _run(j_train.entry_func, "--project_dir", str(jax_proj),
         "--num_devices", "1", *ARGS, *extra)
    for proj in (port, jax_proj):
        _, rows = _csv(proj)
        assert [r["epoch"] for r in rows] == ["0", "1"]
        assert all(np.isfinite(float(r["loss"])) for r in rows)
    log = (port / "logs" / "train.txt").read_text()
    assert "'Limitation' queue created" in log
    assert "Sampler: per-image path (volume pool capacity 2 < batch " \
        "size 4)" in log
    assert "Reload: unloaded" in log


def test_jax_trained_weights_load_in_port(trained):
    """The JAX package's `mp train` weights run in the port's UNet with
    the JAX UNet's outputs (within 1e-5)."""
    import jax.numpy as jnp

    from multiplanarunet_tpu.models.unet import UNet as JUNet
    from multiplanarunet_tpu_torch.models.model_init import (
        build_model,
        load_unet_weights,
    )

    _, _, jax_proj = trained
    path = jax_proj / "model" / "model_weights.npz"
    build = yaml.safe_load((jax_proj / "train_hparams.yaml").read_text())[
        "build"]
    model = load_unet_weights(build_model(build), path)
    params, stats, _ = jckpt.load_weights(path)
    x = np.random.RandomState(2).randn(2, 32, 32, 1).astype(np.float32)
    jmodel = JUNet(dim=32, n_classes=4, n_channels=1, depth=2,
                   init_filters=8)
    want = np.asarray(jmodel.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5)
