"""The port's multi-process `mp` scripts on the CPU: each contract of
`tests/test_distributed_cli.py` on the port's `mp train`, `mp predict`,
`mp train_fusion` and `mp predict_3D`, run as OS processes under the
MPUNET_* launch markers (a gloo group, `--device cpu`) over one shared toy
project: artefacts are written exactly once, the multi-process results
equal a single-process run's, and each non-main rank keeps its own log.
`mp predict` also runs with more ranks than images (an idle rank, which
must still meet every barrier)."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from multiplanarunet_tpu_torch.bin import (
    init_project,
    predict,
    toy_data,
    train,
    train_fusion,
)
from multiplanarunet_tpu_torch.logging.log_results import ResultTable
from multiplanarunet_tpu_torch.models import checkpoint
from tests.test_torch_distributed import launch

REPO = Path(__file__).resolve().parents[1]

WRAPPER = r"""
import sys

import torch

torch.set_num_threads(1)
entry, argv = sys.argv[1], sys.argv[2:]
from multiplanarunet_tpu_torch.bin import (
    predict, predict_3D, train, train_fusion)

{"train": train, "predict": predict, "predict_3D": predict_3D,
 "train_fusion": train_fusion}[entry].entry_func(argv)
print("WORKER_OK")
"""


def _launch_group(tmp_dir, entry, argv, n_procs=2):
    """`entry_func(argv + --device cpu)` of bin/<entry> in n_procs ranks."""
    script = Path(tmp_dir) / "cli_worker.py"
    script.write_text(WRAPPER)
    outs = launch(script, [entry, *argv, "--device", "cpu"], n_procs,
                  tmp_dir)
    assert all("WORKER_OK" in out for out in outs)
    return outs


def _in_process(entry, argv):
    cwd = os.getcwd()
    try:
        return entry.entry_func([*argv, "--device", "cpu"])
    finally:
        os.chdir(cwd)


def _shrink(proj, pairs):
    hp = proj / "train_hparams.yaml"
    text = hp.read_text()
    for old, new in pairs:
        assert old in text, old
        text = text.replace(old, new)
    hp.write_text(text)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """Toy data and a project from the port's init_project, trained by two
    `mp train` processes."""
    ws = tmp_path_factory.mktemp("torch_dist_cli")
    toy_data.entry_func(["--out_dir", str(ws / "data"), "--N_train", "3",
                         "--N_val", "2", "--N_test", "2", "--image_size",
                         "32", "--seed", "1"])
    init_project.entry_func(["--name", "proj", "--root", str(ws),
                             "--data_dir", str(ws / "data")])
    proj = ws / "proj"
    _shrink(proj, (("dim: Null", "dim: 32"),
                   ("complexity_factor: 2", "complexity_factor: 0.02"),
                   ("depth: 4", "depth: 2"), ("views: 6", "views: 2"),
                   ("mixed_precision: True", "mixed_precision: False")))
    _launch_group(ws, "train", [
        "--project_dir", str(proj), "--overwrite", "--no_images",
        "--epochs", "2", "--train_images_per_epoch", "16",
        "--val_images_per_epoch", "8"])
    return proj


def test_train_artifacts_written_exactly_once(project):
    """views.npz, the weights, one best checkpoint and one CSV row per
    epoch from the main process; rank 1 keeps logs/train_rank1.txt."""
    views = np.load(project / "views.npz")["arr_0"]
    assert views.shape == (2, 3)
    assert (project / "model" / "model_weights.npz").exists()
    assert len(list((project / "model").glob("@epoch_*val_dice*.npz"))) == 1
    lines = (project / "logs" / "training.csv").read_text().splitlines()
    head = lines[0].split(",")
    rows = [dict(zip(head, r.split(","))) for r in lines[1:]]
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert all(np.isfinite(float(r["val_dice"])) for r in rows)
    logs = {p.name for p in (project / "logs").glob("train*")}
    assert {"train.txt", "train_rank1.txt"} <= logs, logs
    rank1 = (project / "logs" / "train_rank1.txt").read_text()
    assert "dropped file-writing callbacks" in rank1


PREDICT_ARGS = ["--sum_fusion", "--overwrite", "--n_planes", "same"]


@pytest.fixture(scope="module")
def single_process_predict(project):
    _in_process(predict, ["--project_dir", str(project), "--out_dir",
                          "predictions_sp", *PREDICT_ARGS])
    return ResultTable.read_csv(project / "predictions_sp" / "csv" /
                                "results.csv")


@pytest.mark.parametrize("n_procs", [2, 3])
def test_multiprocess_predict_matches_single_process(
        project, single_process_predict, tmp_path, n_procs):
    """`mp predict` over n_procs ranks (3: one rank has no image) writes one
    merged results.csv equal to the single-process one within 1e-6, no
    rank folder left, each image's PRED.nii.gz once; every rank logs."""
    out_name = f"predictions_mp{n_procs}"
    _launch_group(tmp_path, "predict", [
        "--project_dir", str(project), "--out_dir", out_name,
        *PREDICT_ARGS], n_procs=n_procs)
    out = project / out_name
    sp = single_process_predict
    mp = ResultTable.read_csv(out / "csv" / "results.csv")
    assert mp.index == sp.index and mp.columns == sp.columns
    assert np.isfinite(mp.values).all()
    np.testing.assert_allclose(mp.values, sp.values, rtol=0, atol=1e-6)
    assert not list(out.glob(".rank*"))
    nii = sorted(p.name for p in (out / "nii_files").iterdir())
    assert len(nii) == len(set(nii)) == 2
    for d in (out / "nii_files").iterdir():
        assert (d / "PRED.nii.gz").exists()
    logs = {p.name for p in out.glob("predict_log*")}
    assert logs == {"predict_log.txt"} | {
        f"predict_log_rank{r}.txt" for r in range(1, n_procs)}
    if n_procs == 3:
        idle = (out / "predict_log_rank2.txt").read_text()
        assert "handles 0/2 images" in idle


def test_multiprocess_train_fusion_matches_single_process(project,
                                                         tmp_path):
    """Two `mp train_fusion` ranks split the mapping; rank 0 fits on every
    point in image order and writes ONE fusion checkpoint within 1e-6 of
    the single-process fit; .points_tmp is removed; rank 1 logs."""
    args = ["--project_dir", str(project), "--overwrite",
            "--images_per_round", "2", "--min_val_images", "2",
            "--epochs", "3", "--early_stopping", "3", "--n_planes", "same",
            "--seed", "42"]
    _in_process(train_fusion, args)
    fusion_dir = project / "model" / "fusion_weights"
    out = next(fusion_dir.glob("*_fusion_weights.npz"))
    sp_copy = tmp_path / "sp_fusion.npz"
    shutil.copy(out, sp_copy)
    out.unlink()

    _launch_group(tmp_path, "train_fusion", args)
    files = list(fusion_dir.glob("*_fusion_weights.npz"))
    assert len(files) == 1
    assert not (fusion_dir / ".points_tmp").exists()
    sp, _, _ = checkpoint.load_weights(sp_copy)
    mp, _, _ = checkpoint.load_weights(files[0])
    for k in ("W", "b"):
        np.testing.assert_allclose(mp["fusion"][k], sp["fusion"][k], rtol=0,
                                   atol=1e-6)
    logs = {p.name for p in (project / "logs").glob("train_fusion*")}
    assert "train_fusion_rank1.txt" in logs, logs


def test_multiprocess_predict_3d_merges_once(tmp_path_factory, tmp_path):
    """Two `mp predict_3D` ranks split the cohort; rank 0 writes the merged
    3D tables once (finite dice for both images), no .rank*.json left,
    each image's PRED.nii.gz once, rank 1's log beside rank 0's."""
    ws = tmp_path_factory.mktemp("torch_dist_3d")
    toy_data.entry_func(["--out_dir", str(ws / "data"), "--N_train", "2",
                         "--N_val", "1", "--N_test", "2", "--image_size",
                         "32", "--seed", "2"])
    init_project.entry_func(["--name", "proj", "--root", str(ws),
                             "--data_dir", str(ws / "data"), "--model",
                             "3D"])
    proj = ws / "proj"
    _shrink(proj, (("dim: Null", "dim: 16\n  init_filters: 4"),
                   ("depth: 3", "depth: 2"),
                   ("mixed_precision: True", "mixed_precision: False"),
                   ("batch_size: 16", "batch_size: 2")))
    _in_process(train, ["--project_dir", str(proj), "--overwrite",
                        "--no_images", "--epochs", "1",
                        "--train_images_per_epoch", "2",
                        "--val_images_per_epoch", "1"])
    _launch_group(tmp_path, "predict_3D", [
        "--project_dir", str(proj), "--out_dir", str(proj / "pred3d"),
        "--overwrite"])
    out = proj / "pred3d"
    assert not list(out.glob(".rank*.json"))
    res = ResultTable.read_csv(out / "csv" / "results.csv")
    assert len(res.index) == 2 and np.isfinite(res.values).all()
    detailed = ResultTable.read_csv(out / "csv" / "detailed.csv")
    assert sorted(detailed.columns) == sorted(res.index)
    nii = sorted(p.name for p in (out / "nii_files").iterdir())
    assert len(nii) == len(set(nii)) == 2
    logs = {p.name for p in out.glob("predict_log*")}
    assert "predict_log_rank1.txt" in logs, logs


def test_view_parallel_predict_matches_single_device(
        project, single_process_predict):
    """`mp predict --num_devices 2 --device cpu --no_eval` runs each image's
    views over two device entries (predict_image_sharded); its class maps
    equal the single-device run's in at least 0.9999 of the voxels (the
    fusion sums differ only in their order)."""
    from multiplanarunet_tpu_torch.io import nifti

    _in_process(predict, ["--project_dir", str(project), "--out_dir",
                          "predictions_vp", "--no_eval", "--num_devices",
                          "2", *PREDICT_ARGS])
    log = (project / "predictions_vp" / "predict_log.txt").read_text()
    assert "View-parallel inference over 2 devices" in log
    for image_id in single_process_predict.index:
        got, want = (nifti.load(project / out / "nii_files" / image_id /
                                "PRED.nii.gz").get_raw_data()
                     for out in ("predictions_vp", "predictions_sp"))
        assert got.shape == want.shape
        assert (got == want).mean() >= 0.9999


@pytest.mark.parametrize("resampler", ["shear", "gather"])
def test_predict_image_sharded_matches_predict_image(project, resampler):
    """predict_image_sharded over [cpu, cpu, cpu] (view v on entry v % 3;
    two views, so two accumulators) against predict_image on one test
    image with learned-fusion weights: the class maps agree in at least
    0.9999 of the voxels, through the shear path and the gather
    fallback."""
    import torch

    from multiplanarunet_tpu_torch.hyperparameters.hparams import (
        YAMLHParams,
    )
    from multiplanarunet_tpu_torch.image.image_pair import ImagePair
    from multiplanarunet_tpu_torch.models.model_init import (
        build_model,
        load_unet_weights,
    )
    from multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict import (
        MultiViewPredictor,
    )

    hparams = YAMLHParams(project / "train_hparams.yaml", no_log=True)
    views = np.load(project / "views.npz")["arr_0"]
    model = load_unet_weights(build_model(hparams["build"]),
                              project / "model" / "model_weights.npz").eval()
    predictor = MultiViewPredictor(
        model, sample_dim=hparams["build"]["dim"],
        real_space_span=hparams["fit"]["real_space_span"],
        n_classes=hparams["build"]["n_classes"], device="cpu",
        resampler=resampler)
    test_dir = Path(hparams["test_data"]["base_dir"])
    pair = ImagePair(test_dir / "images" / "test_000.nii.gz")
    pair.set_bg_value(hparams.get_from_anywhere("bg_value"))
    pair.set_scaler(hparams.get_from_anywhere("scaler"))
    pair.load()
    rng = np.random.RandomState(0)
    n_classes = hparams["build"]["n_classes"]
    fusion = {"fusion": {
        "W": (rng.rand(len(views), n_classes) + 0.5).astype(np.float32),
        "b": (0.1 * rng.randn(1, n_classes)).astype(np.float32)}}
    want, _ = predictor.predict_image(pair, views, fusion_params=fusion,
                                      n_planes="same",
                                      return_per_view=False)
    got = predictor.predict_image_sharded(
        pair, views, [torch.device("cpu")] * 3, fusion_params=fusion,
        n_planes="same")
    modes = predictor.remap_modes
    assert modes == ["gather" if resampler == "gather" else "shear"] * 2
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert (got == want).mean() >= 0.9999
