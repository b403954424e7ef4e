"""The port's 3D prediction against the JAX package's: `pred_3D_iso` and
`predict_3D_patches` with oracle models on a label volume (sums within
1e-5, class maps equal where the sums decide them), `predict_3D_patches_
binary`, and both packages' `mp train` on one tiny
3D project followed by both packages' `mp predict_3D` with the same JAX
weights (the PRED class maps agree on >= 0.999 of voxels). The port runs
with `--device cpu`."""
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from flax import linen as jnn

from multiplanarunet_tpu.bin import predict_3D as j_predict_3D
from multiplanarunet_tpu.image import ImagePairLoader as JLoader
from multiplanarunet_tpu.image.queue import EagerQueue as JEager
from multiplanarunet_tpu.logging import ScreenLogger as JScreen
from multiplanarunet_tpu.models import checkpoint as jckpt
from multiplanarunet_tpu.sequences import get_sequence as j_get_sequence
from multiplanarunet_tpu.utils.fusion import fuse_and_predict as jfp
from multiplanarunet_tpu_torch.bin import mp as t_mp
from multiplanarunet_tpu_torch.image.image_pair_loader import ImagePairLoader
from multiplanarunet_tpu_torch.image.queue.queues import EagerQueue
from multiplanarunet_tpu_torch.io import nifti
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.sequences import get_sequence
from multiplanarunet_tpu_torch.utils.fusion import fuse_and_predict as tfp
from tests.torch_projects import (  # noqa: F401
    run_entry,
    run_jax_entry,
    torch_threads,
    train_args,
    trained_pair,
)


N_CLASSES = 4
SIZE = 24


class JOracle(jnn.Module):
    """one_hot(round(intensity)): fed a label volume as its image, the
    pipeline must give the labels back. soft: softmax(-(intensity -
    c)^2) over the class values c instead, whose argmax is the same but
    which does not jump where a linearly sampled intensity lies half way
    between two classes (and float32 rounding may land on either side)."""

    soft: bool = False

    @jnn.compact
    def __call__(self, x, train=False):
        if self.soft:
            return jax.nn.softmax(
                -((x[..., :1] - jnp.arange(N_CLASSES)) ** 2), axis=-1)
        cls = jnp.clip(jnp.round(x[..., 0]), 0, N_CLASSES - 1)
        return jax.nn.one_hot(cls.astype(jnp.int32), N_CLASSES)


class TOracle(torch.nn.Module):
    """The same oracles on channels-first boxes of any spatial rank."""

    def __init__(self, soft=False):
        super().__init__()
        self.soft = soft

    def forward(self, x):
        if self.soft:
            c = torch.arange(N_CLASSES, dtype=x.dtype).view(
                (1, -1) + (1,) * (x.dim() - 2))
            return torch.softmax(-((x[:, :1] - c) ** 2), dim=1)
        cls = torch.clamp(torch.round(x[:, 0]), 0, N_CLASSES - 1)
        return torch.nn.functional.one_hot(cls.long(), N_CLASSES).movedim(
            -1, 1).float()


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """Both packages' EagerQueues over one oblique, anisotropic label
    volume that is also its own (unscaled) image."""
    root = tmp_path_factory.mktemp("oracle_3d")
    lab = np.zeros((SIZE, SIZE, SIZE), np.uint8)
    lab[4:12, 4:12, 4:12] = 1
    lab[14:20, 6:14, 8:16] = 2
    lab[6:10, 14:20, 14:20] = 3
    affine = np.diag([1.0, 1.1, 0.9, 1.0])
    for sub, arr in (("images", lab.astype(np.float32)), ("labels", lab)):
        (root / sub).mkdir()
        nifti.save(arr, root / sub / "img.nii.gz", affine=affine)
    out = {}
    for name, loader_cls, queue_cls, log in (
            ("jax", JLoader, JEager, JScreen(False)),
            ("port", ImagePairLoader, EagerQueue, ScreenLogger(False))):
        loader = loader_cls(base_dir=root, logger=log, no_log=True)
        loader.set_scaler_and_bg_values(bg_value=0.0, scaler=None)
        out[name] = queue_cls(loader, logger=log)
    return out, lab


def _iso_sequences(queues, noise_sd):
    kw = dict(intrp_style="iso_live_3d", dim=16, batch_size=1,
              n_classes=N_CLASSES, real_box_dim=14.0, noise_sd=noise_sd,
              no_log=True)
    return (j_get_sequence(queues["jax"], logger=JScreen(False), **kw),
            get_sequence(queues["port"], logger=ScreenLogger(False),
                         device="cpu", **kw))


def _predict_fns(soft=False):
    jmodel = JOracle(soft=soft)
    return (jax.jit(lambda x: jmodel.apply({"params": {}}, x)),
            tfp.unet_predict_fn(TOracle(soft), "cpu"))


@pytest.mark.parametrize("noise_sd,extra,min_coverage", [
    (0.0, 0, None), (0.1, "2x", None), (0.1, 3, 0.999)])
def test_pred_3d_iso_matches_jax(oracle, noise_sd, extra, min_coverage):
    """The box sums within 1e-5 and the uint8 class maps equal, base boxes
    then extra random boxes (one np.random seed) then coverage rounds;
    the (soft) oracle's class map reconstructs the interior labels."""
    queues, lab = oracle
    jseq, tseq = _iso_sequences(queues, noise_sd)
    jfn, tfn = _predict_fns(soft=True)
    jimage = queues["jax"].dataset.images[0]
    timage = queues["port"].dataset.images[0]
    out = {}
    for name, fn, seq, image in (("jax", jfp, jseq, jimage),
                                 ("port", tfp, tseq, timage)):
        predict_fn = jfn if name == "jax" else tfn
        for argmax in (False, True):
            np.random.seed(6)
            out[name, argmax] = fn.pred_3D_iso(
                predict_fn, seq, image, extra_boxes=extra,
                min_coverage=min_coverage, want_argmax=argmax)
    want, got = np.asarray(out["jax", False]), out["port", False]
    assert got.shape == lab.shape + (N_CLASSES,) and got.dtype == np.float32
    # sums of up to ~10 boxes' probabilities: 1e-5 and 1e-6 of the sum
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    cls = out["port", True]
    assert cls.dtype == np.uint8
    np.testing.assert_array_equal(cls, got.argmax(-1))
    # equal wherever the sums decide the class; the soft oracle ties two
    # classes exactly where an intensity is sampled half way between them
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0] > 1e-4) | (top2[..., 1] == 0)
    assert decided.mean() > 0.99
    np.testing.assert_array_equal(cls[decided],
                                  np.asarray(out["jax", True])[decided])
    covered = got.sum(-1) > 0
    interior = np.zeros(lab.shape, bool)
    interior[2:-2, 2:-2, 2:-2] = True
    assert covered[interior].mean() > 0.95
    assert (cls == lab)[interior & covered].mean() > 0.9
    if min_coverage:
        assert covered.mean() >= min_coverage


@pytest.mark.parametrize("style,n_extra", [("patches_3d", 0),
                                           ("sliding_patches_3d", 3)])
def test_predict_3d_patches_matches_jax(oracle, style, n_extra):
    """The normalised recon within 1e-5 and the class maps equal (equal
    to the labels: the oracle's patches tile the volume)."""
    queues, lab = oracle
    kw = dict(intrp_style=style, dim=10, batch_size=1, n_classes=N_CLASSES,
              no_log=True)
    jseq = j_get_sequence(queues["jax"], logger=JScreen(False), **kw)
    tseq = get_sequence(queues["port"], logger=ScreenLogger(False),
                        device="cpu", **kw)
    jfn, tfn = _predict_fns()
    jimage = queues["jax"].dataset.images[0]
    timage = queues["port"].dataset.images[0]
    out = {}
    for argmax in (False, True):
        np.random.seed(2)
        out["jax", argmax] = np.asarray(jfp.predict_3D_patches(
            jfn, jseq, jimage, n_extra=n_extra, want_argmax=argmax))
        np.random.seed(2)
        out["port", argmax] = tfp.predict_3D_patches(
            tfn, tseq, timage, n_extra=n_extra, want_argmax=argmax)
    np.testing.assert_allclose(out["port", False], out["jax", False],
                               atol=1e-5)
    np.testing.assert_array_equal(out["port", True], out["jax", True])
    assert (out["port", True] == lab).mean() > 0.99


def test_predict_3d_patches_binary_matches_jax(oracle):
    """The binary vote recon of a one-output model (foreground where the
    intensity is at least 0.5) over base and random patches: the uint8
    masks equal, and equal to the foreground."""
    queues, lab = oracle
    kw = dict(intrp_style="patches_3d", dim=10, batch_size=1,
              n_classes=N_CLASSES, no_log=True)
    jseq = j_get_sequence(queues["jax"], logger=JScreen(False), **kw)
    tseq = get_sequence(queues["port"], logger=ScreenLogger(False),
                        device="cpu", **kw)

    class TFg(torch.nn.Module):
        def forward(self, x):
            return (x[:, :1] >= 0.5).float()

    jfn = jax.jit(lambda x: (x[..., :1] >= 0.5).astype(jnp.float32))
    np.random.seed(4)
    want = np.asarray(jfp.predict_3D_patches_binary(
        jfn, jseq, queues["jax"].dataset.images[0], n_extra=3))
    np.random.seed(4)
    got = tfp.predict_3D_patches_binary(
        tfp.unet_predict_fn(TFg(), "cpu"), tseq,
        queues["port"].dataset.images[0], n_extra=3)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, lab > 0)


# ---------------------------------------------------------------- the CLIs
SHRINK = (("dim: Null", "dim: 16\n  init_filters: 4"),
          ("depth: 3", "depth: 2"),
          ("batch_size: 16", "batch_size: 4"),
          ("mixed_precision: True", "mixed_precision: False"))


@pytest.fixture(scope="module")
def trained_3d():
    port, jax_proj = trained_pair("3D", SHRINK, train_args(8, 4),
                                  (3, 2, 32, 5))
    return port.parent, port, jax_proj


def test_mp_train_3d_matches_jax(trained_3d):
    """Both packages' `mp train` on the 3D preset: the same CSV columns
    with finite values, the same YAML written back (the Auditor's dim,
    real_box_dim, real_space_span, n_classes), the pooled 3D sampler named
    in the port's log, and weight files of the JAX package's keys and
    shapes."""
    _, port, jax_proj = trained_3d
    heads, rows = {}, {}
    for name, proj in (("port", port), ("jax", jax_proj)):
        lines = (proj / "logs" / "training.csv").read_text().splitlines()
        heads[name] = lines[0].split(",")
        rows[name] = [dict(zip(heads[name], r.split(","))) for r in lines[1:]]
    assert heads["port"] == heads["jax"]
    assert [r["epoch"] for r in rows["port"]] == ["0", "1"]
    for row in rows["port"]:
        for key in ("loss", "val_loss", "val_dice", "lr"):
            assert np.isfinite(float(row[key])), key
    p_yaml, j_yaml = (yaml.safe_load((p / "train_hparams.yaml").read_text())
                      for p in (port, jax_proj))
    for group in ("train_data", "val_data", "test_data"):
        p_yaml.pop(group), j_yaml.pop(group)  # per-project paths
    assert p_yaml == j_yaml
    assert p_yaml["build"]["dim"] == 16 and p_yaml["build"]["n_classes"] == 4
    assert p_yaml["fit"]["real_box_dim"] == 16.0
    log = (port / "logs" / "train.txt").read_text()
    assert "Sampler: pooled path (isotropic 3D boxes" in log
    pp, ps, _ = jckpt.load_weights(port / "model" / "model_weights.npz")
    jp, js, _ = jckpt.load_weights(jax_proj / "model" / "model_weights.npz")
    shapes = lambda t: jax.tree.map(np.shape, t)  # noqa: E731
    assert shapes(pp) == shapes(jp) and shapes(ps) == shapes(js)
    # 5 conv blocks of 6 leaves, 2 up convs and norms, the out conv
    assert len(jax.tree.leaves(pp)) == 5 * 6 + 2 * 4 + 2


@pytest.mark.parametrize("extra", [[], ["--strides", "8"]])
def test_mp_predict_3d_matches_jax(trained_3d, extra):
    """Both packages' `mp predict_3D` on the JAX-trained project (box mode
    with its default 2x extra boxes under one np.random seed, or
    sliding-patch mode): PRED class maps of the image's shape agreeing on
    >= 0.999 of voxels, results.csv and detailed.csv for every image."""
    _, _, jax_proj = trained_3d
    tag = "patches" if extra else "boxes"
    args = ["--project_dir", str(jax_proj), "--overwrite", *extra]
    np.random.seed(9)
    run_jax_entry(j_predict_3D.entry_func, *args, "--out_dir", f"jax_{tag}")
    np.random.seed(9)
    timings = run_entry(t_mp.entry_func, "predict_3D", *args, "--out_dir",
                        f"port_{tag}", "--device", "cpu")
    assert sorted(timings) == ["val_000", "val_001"]
    for image_id in timings:
        pred = {}
        for name in ("jax", "port"):
            path = (jax_proj / f"{name}_{tag}" / "nii_files" / image_id /
                    "PRED.nii.gz")
            pred[name] = nifti.load(path).get_raw_data()
        assert pred["port"].shape == (32, 32, 32)
        assert (pred["port"] == pred["jax"]).mean() >= 0.999
    for fname in ("results.csv", "detailed.csv"):
        texts = [(jax_proj / f"{n}_{tag}" / "csv" / fname).read_text()
                 for n in ("jax", "port")]
        assert texts[0].splitlines()[0] == texts[1].splitlines()[0]
        assert len(texts[0].splitlines()) == len(texts[1].splitlines())
