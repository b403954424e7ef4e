"""The project workflow scripts of the PyTorch port against the JAX
package's: the preset copies and `mp init_project`, `mp toy_data`, `mp
summary`, `mp cv_split` and `mp cv_experiment`, each run by both packages
on the same inputs."""
import contextlib
import io
import os
from pathlib import Path

import numpy as np
import pytest

from multiplanarunet_tpu.bin import cv_experiment as j_cv_experiment
from multiplanarunet_tpu.bin import cv_split as j_cv_split
from multiplanarunet_tpu.bin import init_project as j_init_project
from multiplanarunet_tpu.bin import summary as j_summary
from multiplanarunet_tpu.bin import toy_data as j_toy_data
from multiplanarunet_tpu.io import nifti as jnifti
from multiplanarunet_tpu_torch.bin import cv_experiment as t_cv_experiment
from multiplanarunet_tpu_torch.bin import cv_split as t_cv_split
from multiplanarunet_tpu_torch.bin import init_project as t_init_project
from multiplanarunet_tpu_torch.bin import mp as t_mp
from multiplanarunet_tpu_torch.bin import summary as t_summary
from multiplanarunet_tpu_torch.bin import toy_data as t_toy_data
from multiplanarunet_tpu_torch.io import nifti as tnifti
from multiplanarunet_tpu_torch.logging import log_results as tlr
from tests.torch_projects import torch_threads  # noqa: F401

JAX_DEFAULTS = j_init_project.defaults_dir()
PORT_DEFAULTS = t_init_project.defaults_dir()
PRESET_FILES = sorted(str(p.relative_to(JAX_DEFAULTS))
                      for p in JAX_DEFAULTS.glob("*/*.yaml"))


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        fn(*args)
    return out.getvalue()


# ------------------------------------------------------- presets, projects
@pytest.mark.parametrize("name", PRESET_FILES)
def test_preset_copies_are_byte_equal(name):
    assert (PORT_DEFAULTS / name).read_bytes() == \
        (JAX_DEFAULTS / name).read_bytes()
    assert "multiplanarunet_tpu_torch" in str(PORT_DEFAULTS)


@pytest.mark.parametrize("data_dir", [False, True])
@pytest.mark.parametrize("preset", ["MultiPlanar", "3D", "MultiTask"])
def test_init_project_writes_the_jax_text(tmp_path, preset, data_dir):
    """Both packages' init_project write the same files with the same
    text, with and without --data_dir; an existing folder raises without
    --overwrite (stdin is not a tty here)."""
    for name, mod in (("j", j_init_project), ("t", t_init_project)):
        args = ["--name", name, "--root", str(tmp_path), "--model", preset]
        if data_dir:
            args += ["--data_dir", str(tmp_path / "data")]
        _quiet(mod.entry_func, args)
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "t")) and files
    for f in files:
        text = (tmp_path / "t" / f).read_text()
        assert text == (tmp_path / "j" / f).read_text(), f
        assert (f"{tmp_path / 'data'}/train" in text) == data_dir
    with pytest.raises(OSError, match="already exists"):
        t_init_project.entry_func(["--name", "t", "--root", str(tmp_path)])
    with pytest.raises(OSError, match="does not exist"):
        t_init_project.entry_func(["--name", "x", "--root",
                                   str(tmp_path / "missing")])


# ---------------------------------------------------------------- toy data
@pytest.mark.parametrize("n_channels", [1, 2])
@pytest.mark.parametrize("vary_size", [False, True])
def test_toy_data_writes_the_jax_arrays(tmp_path, vary_size, n_channels):
    for name, mod in (("j", j_toy_data), ("t", t_toy_data)):
        mod.create_dataset(tmp_path / name, 2, 24, n_channels,
                           np.random.RandomState(5), "x",
                           pixdim=(1.0, 1.2, 0.9), vary_size=vary_size)
    for sub in ("images", "labels"):
        names = sorted(os.listdir(tmp_path / "j" / sub))
        assert names == sorted(os.listdir(tmp_path / "t" / sub)) and names
        for f in names:
            want = jnifti.load(tmp_path / "j" / sub / f)
            got = tnifti.load(tmp_path / "t" / sub / f)
            assert got.get_data_dtype() == want.get_data_dtype()
            np.testing.assert_array_equal(got.get_raw_data(),
                                          want.get_raw_data())
            np.testing.assert_array_equal(got.affine, want.affine)
            if sub == "images":
                assert got.shape[3:] == ((2,) if n_channels == 2 else ())


def test_mp_toy_data_cli(tmp_path):
    for name, entry in (("j", j_toy_data.entry_func),
                        ("t", lambda a: t_mp.entry_func(["toy_data"] + a))):
        _quiet(entry, ["--out_dir", str(tmp_path / name), "--N_train", "2",
                       "--N_val", "1", "--N_test", "1", "--image_size", "16",
                       "--seed", "3"])
    for split, n in (("train", 2), ("val", 1), ("test", 1)):
        files = sorted((tmp_path / "t" / split / "labels").iterdir())
        assert len(files) == n
        for f in files:
            j = tmp_path / "j" / split / "labels" / f.name
            np.testing.assert_array_equal(tnifti.load(f).get_raw_data(),
                                          jnifti.load(j).get_raw_data())


# ------------------------------------------------------------------ summary
def _result_dir(root, ids, views, seed, nan_rows=(), nan_class=None):
    """A csv/ folder as `mp predict` writes it: per-view and MJ dice,
    NaN for the images in nan_rows and, in MJ.csv, for the class
    nan_class of every image."""
    rng = np.random.RandomState(seed)
    results, pc = tlr.init_result_dicts(views, ids, 4)
    for image_id in ids:
        for key in [str(v) for v in views] + ["MJ"]:
            dices = rng.rand(3).astype(np.float32)
            if key == "MJ" and nan_class is not None:
                dices[nan_class - 1] = np.nan
            if image_id in nan_rows:
                dices[:] = np.nan
            pc[key].set_column(image_id, dices)
            results.set(image_id, key, np.nanmean(dices) if
                        np.isfinite(dices).any() else np.nan)
    root.mkdir(parents=True)
    tlr.save_all(results, pc, root)
    return str(root / "csv")


@pytest.mark.parametrize("case", ["one", "nan_cells", "two_dirs"])
def test_summary_report_equals_jax(tmp_path, case):
    views = [np.array([0.6, 0.0, 0.8]), np.array([0.0, 1.0, 0.0])]
    if case == "one":  # one image: the std is NaN
        dirs = [_result_dir(tmp_path / "b", ["s1"], views, 1)]
    else:
        dirs = [_result_dir(tmp_path / "a", ["s1", "s2", "s3"], views, 0)]
    if case in ("nan_cells", "two_dirs"):
        dirs.append(_result_dir(tmp_path / "c", ["s1", "s2", "s3"], views, 2,
                                nan_rows=("s2",), nan_class=2))
    if case == "two_dirs":
        dirs.append(_result_dir(tmp_path / "d", ["s4", "s5"], views, 3,
                                nan_rows=("s4", "s5")))
    want = j_summary.build_report(j_summary.find_result_dirs(str(tmp_path)))
    assert t_summary.find_result_dirs(str(tmp_path)) == sorted(dirs)
    got = t_summary.build_report(t_summary.find_result_dirs(str(tmp_path)))
    assert got == want
    assert "Overall fused mean dice" in got and "Per-view mean dice" in got
    if case != "one":
        assert "nan" in got
    out = {}
    for name, entry in (("j", j_summary.entry_func),
                        ("t", lambda a: t_mp.entry_func(["summary"] + a))):
        printed = _quiet(entry, ["--dir", str(tmp_path / "*"), "--out",
                                 str(tmp_path / f"{name}.txt")])
        out[name] = (printed, (tmp_path / f"{name}.txt").read_text())
    assert out["t"] == out["j"]
    assert _quiet(t_summary.entry_func, ["--dir", str(tmp_path / "none")]) \
        == _quiet(j_summary.entry_func, ["--dir", str(tmp_path / "none")])


# ------------------------------------------------------------- CV tools
@pytest.fixture(scope="module")
def flat_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("cvdata")
    t_toy_data.create_dataset(root, 10, 16, 1, np.random.RandomState(0),
                              "im")
    return root


def _tree(root):
    """{relative path: what it holds}: a symlink's target, a file's bytes."""
    out = {}
    for path in sorted(Path(root).rglob("*")):
        rel = str(path.relative_to(root))
        if path.is_symlink():
            out[rel] = ("link", os.readlink(path))
        elif path.is_file():
            out[rel] = ("file", path.read_bytes())
    return out


@pytest.mark.parametrize("extra", [
    ["--CV", "5", "--validation_fraction", "0.25"],
    ["--CV", "3", "--copy", "--seed", "4"],
    ["--CV", "1", "--test_fraction", "0.3", "--file_list"],
])
def test_cv_split_trees_equal_jax(flat_dataset, tmp_path, extra):
    for name, entry in (("j", j_cv_split.entry_func),
                        ("t", lambda a: t_mp.entry_func(["cv_split"] + a))):
        printed = _quiet(entry, ["--data_dir", str(flat_dataset),
                                 "--out_dir", str(tmp_path / name), *extra])
        assert "CV splits written to" in printed
    t_tree = _tree(tmp_path / "t")
    assert len(t_tree) >= 6  # 3 subsets x images/labels at least
    assert t_tree == _tree(tmp_path / "j")


def test_cv_experiment_runs_script_and_writes_the_jax_hparams(
        flat_dataset, tmp_path):
    out = tmp_path / "cv"
    _quiet(t_cv_split.entry_func, ["--data_dir", str(flat_dataset), "--CV",
                                   "2", "--out_dir", str(out)])
    script = tmp_path / "script"
    script.write_text("# a comment\n"
                      "echo running on [split_dir] > marker.txt\n")
    proto = PORT_DEFAULTS / "MultiPlanar" / "train_hparams.yaml"
    for name, mod in (("j", j_cv_experiment), ("t", t_cv_experiment)):
        _quiet(mod.entry_func, ["--CV_dir", str(out), "--out_dir",
                                str(tmp_path / name), "--script_prototype",
                                str(script), "--hparams_prototype",
                                str(proto), "--jobs", "2"])
    for i in range(2):
        marker = tmp_path / "t" / f"split_{i}" / "marker.txt"
        assert f"split_{i}" in marker.read_text()
        hp = tmp_path / "t" / f"split_{i}" / "train_hparams.yaml"
        assert hp.read_text() == (tmp_path / "j" / f"split_{i}" /
                                  "train_hparams.yaml").read_text()
        assert f"{out / f'split_{i}'}/train" in hp.read_text()
        assert (tmp_path / "t" / f"split_{i}.log").read_text().startswith(
            "$ echo running on")


def test_cv_experiment_aborts_split_on_failure(flat_dataset, tmp_path):
    out = tmp_path / "cv"
    _quiet(t_cv_split.entry_func, ["--data_dir", str(flat_dataset), "--CV",
                                   "1", "--out_dir", str(out)])
    script = tmp_path / "script"
    script.write_text("false\necho should_not_run > marker.txt\n")
    exp_out = tmp_path / "exp"
    with pytest.raises(SystemExit, match="split_0"):
        _quiet(t_mp.entry_func, ["cv_experiment", "--CV_dir", str(out),
                                 "--out_dir", str(exp_out),
                                 "--script_prototype", str(script),
                                 "--hparams_prototype", "/nonexistent.yaml"])
    assert not (exp_out / "split_0" / "marker.txt").exists()
    assert not (exp_out / "split_0" / "train_hparams.yaml").exists()
    with pytest.raises(OSError, match="No split_N folders"):
        t_cv_experiment.entry_func(["--CV_dir", str(exp_out / "split_0")])


def test_yaml_save_is_never_seen_half_written(tmp_path):
    """A process reading a project's YAML while the main process saves it
    (a rank starting `mp train` while rank 0 stamps the file) reads a
    whole file: 2 s of saves in a loop against a reader thread."""
    import threading
    import time

    from multiplanarunet_tpu_torch.hyperparameters.hparams import (
        YAMLHParams,
    )

    path = tmp_path / "train_hparams.yaml"
    path.write_text("build:\n  n_classes: 3\n\nfit:\n  views: 6\n"
                    + "# padding\n" * 2000)
    hp = YAMLHParams(path, no_log=True)
    stop = threading.Event()
    seen = []

    def read():
        while not stop.is_set():
            try:
                seen.append("fit" in YAMLHParams(
                    path, no_log=True, no_version_control=True))
            except Exception:  # an empty or cut file fails to parse
                seen.append(False)

    reader = threading.Thread(target=read)
    reader.start()
    try:
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            hp.save_current()
    finally:
        stop.set()
        reader.join(timeout=30)
    assert not reader.is_alive()
    assert seen and all(seen), \
        f"{seen.count(False)} of {len(seen)} reads saw no 'fit' group"
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["train_hparams.yaml"]
