"""Fusion training of the PyTorch port on the CPU against the JAX package:
the per-view mapped probabilities and the device-resident points of
`MultiViewPredictor`, the fusion loss (GDL over the voxel batch + the
regulariser), its gradients, Adam and the validation counts, `_fit_fusion`
epoch for epoch, and `mp train_fusion` end to end on a tiny project run by
both packages, whose fusion files each package's `mp predict` reads."""
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from multiplanarunet_tpu.bin import predict as j_predict
from multiplanarunet_tpu.bin import train_fusion as j_train_fusion
from multiplanarunet_tpu.evaluate.losses import (
    SparseGeneralizedDiceLoss as JGDL,
)
from multiplanarunet_tpu.image.volume_sampler import (
    VolumeSampler as JVolumeSampler,
)
from multiplanarunet_tpu.models import checkpoint as jckpt
from multiplanarunet_tpu.models.fusion_model import FusionLayer
from multiplanarunet_tpu.models.fusion_model import FusionModel as JFusion
from multiplanarunet_tpu.models.unet import UNet as JUNet
from multiplanarunet_tpu.ops import geometry as jgeo
from multiplanarunet_tpu.utils.fusion import (
    MultiViewPredictor as JMultiViewPredictor,
)
from multiplanarunet_tpu_torch._device import TooFewDevicesError
from multiplanarunet_tpu_torch.bin import init_project as t_init_project
from multiplanarunet_tpu_torch.bin import mp as t_mp
from multiplanarunet_tpu_torch.bin import toy_data as t_toy_data
from multiplanarunet_tpu_torch.bin import train_fusion as t_train_fusion
from multiplanarunet_tpu_torch.evaluate.losses import (
    SparseGeneralizedDiceLoss,
)
from multiplanarunet_tpu_torch.image.volume_sampler import VolumeSampler
from multiplanarunet_tpu_torch.models import checkpoint as tckpt
from multiplanarunet_tpu_torch.models.fusion_model import (
    FusionModel,
    params_tree,
)
from multiplanarunet_tpu_torch.models.unet import UNet
from multiplanarunet_tpu_torch.train.optimizers import Adam
from multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict import (
    MultiViewPredictor,
)
from multiplanarunet_tpu_torch.utils.fusion.fusion_training import (
    predict_and_map,
    stack_collections,
)

torch.set_num_threads(2)

DIM = 32
N_CLASSES = 3
CPU = torch.device("cpu")


def _jax_unet_checkpoint(path, n_classes, seed=0, sharpen=8.0):
    """Random JAX UNet weights (dim 32, depth 2, 8 filters) saved in the
    JAX format, the out conv sharpened so classes are not near-ties."""
    model = JUNet(dim=DIM, n_classes=n_classes, n_channels=1, depth=2,
                  init_filters=8)
    v = jax.jit(lambda k: model.init(k, jnp.zeros((1, DIM, DIM, 1)),
                                     train=False))(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, v["params"])
    params["out_conv"]["kernel"] = params["out_conv"]["kernel"] * sharpen
    params["out_conv"]["bias"] = np.zeros(n_classes, np.float32)
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    jckpt.save_weights(path, params, stats)
    return model, {"params": params, "batch_stats": stats}


class _Image:
    """Minimal labelled ImagePair stand-in."""

    def __init__(self, volume, labels, affine, sampler):
        self.shape = volume.shape
        self.affine = affine
        self.labels = labels
        self.interpolator = sampler


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "unet.npz"
    jmodel, variables = _jax_unet_checkpoint(path, N_CLASSES)
    p, s, _ = tckpt.load_weights(path)
    model = UNet(n_classes=N_CLASSES, n_channels=1, depth=2, init_filters=8)
    model.load_state_dict(tckpt.unet_state_dict_from_jax(p, s, model))
    model.eval()
    from scipy import ndimage

    rng = np.random.RandomState(0)
    shape = (26, 30, 24)
    vol = ndimage.gaussian_filter(rng.randn(*shape), 2.0)
    vol = (vol / vol.std())[..., None].astype(np.float32)
    labels = np.digitize(vol[..., 0], [-0.4, 0.5]).astype(np.uint8)
    R = jgeo.rotation_matrix([0, 0, 1], angle_deg=20)
    affine = np.eye(4)
    affine[:3, :3] = R @ np.diag([1.0, 1.1, 0.9])
    jimg = _Image(vol, labels, affine, JVolumeSampler(vol, None, affine, 0.0))
    timg = _Image(vol, labels, affine, VolumeSampler(vol, affine, 0.0))
    jpred = JMultiViewPredictor(jmodel, variables, sample_dim=DIM,
                                real_space_span=30.0, n_classes=N_CLASSES)
    tpred = MultiViewPredictor(model, sample_dim=DIM, real_space_span=30.0,
                               n_classes=N_CLASSES, device=CPU)
    views = jgeo.get_random_views(2, rng=np.random.RandomState(5))
    return jpred, tpred, jimg, timg, views


def test_predict_views_mapped_matches_jax(setup):
    """Both cast the U-Net probabilities to bf16 before the nearest remap
    (the gather path's tolerance of tests/test_torch_predict.py: atol
    3e-2); the host assembly of fusion_training equals the JAX one on the
    same mapped volumes."""
    jpred, tpred, jimg, timg, views = setup
    want = jpred.predict_views_mapped(jimg, views, n_planes="same+4")
    got = tpred.predict_views_mapped(timg, views, n_planes="same+4")
    assert got.dtype == np.float32
    assert got.shape == want.shape == (2,) + jimg.shape[:3] + (N_CLASSES,)
    np.testing.assert_allclose(got, want, atol=3e-2)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=2e-2)
    X, y = predict_and_map(tpred, timg, views, n_planes="same+4")
    assert X.shape == (int(np.prod(jimg.shape[:3])), 2, N_CLASSES)
    np.testing.assert_array_equal(X, np.moveaxis(
        got.reshape(2, -1, N_CLASSES), 0, 1))
    np.testing.assert_array_equal(y, timg.labels.reshape(-1))
    X2, y2 = stack_collections([X, X[:5]], [y, y[:5]])
    assert X2.shape[0] == y2.shape[0] == X.shape[0] + 5


def test_predict_views_points_full_and_subsets(setup):
    """max_points=None: the mapped volumes reshaped, the labels as int32.
    With max_points: rows and targets are the same subset of those, the
    first max_points of torch.randperm under the caller's generator; the
    same seed gives the same subset, another seed another."""
    _, tpred, _, timg, views = setup
    mapped = tpred.predict_views_mapped(timg, views, n_planes="same")
    pts, tgt = tpred.predict_views_points(timg, views, n_planes="same")
    assert pts.dtype == torch.float32 and tgt.dtype == torch.int32
    full = np.moveaxis(mapped.reshape(2, -1, N_CLASSES), 0, 1)
    np.testing.assert_array_equal(pts.numpy(), full)
    np.testing.assert_array_equal(tgt.numpy(), timg.labels.reshape(-1))
    subsets = []
    for seed in (7, 7, 8):
        gen = torch.Generator().manual_seed(seed)
        p, t = tpred.predict_views_points(timg, views, n_planes="same",
                                          max_points=500, generator=gen)
        idx = torch.randperm(full.shape[0],
                             generator=torch.Generator().manual_seed(seed))
        idx = idx[:500].numpy()
        assert p.shape == (500, 2, N_CLASSES) and t.shape == (500,)
        np.testing.assert_array_equal(p.numpy(), full[idx])
        np.testing.assert_array_equal(t.numpy(), tgt.numpy()[idx])
        subsets.append(idx)
    np.testing.assert_array_equal(subsets[0], subsets[1])
    assert not np.array_equal(subsets[0], subsets[2])


# ------------------------------------------------------------ fusion fit
def _points(n, V, C, seed):
    """(points (n, V, C) probability stacks, targets (n,)): views of
    different quality around the true class."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, C, n)
    quality = np.linspace(2.5, 0.5, V)[None, :, None]
    logits = rng.randn(n, V, C) + quality * np.eye(C)[y][:, None, :]
    p = np.exp(logits)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32), y


def _jax_counts(W, b, X, y, C):
    """The JAX package's val_counts (train_fusion.py:128-135)."""
    fm = JFusion(n_inputs=X.shape[1], n_classes=C)
    pred = jnp.argmax(fm.apply({"params": {"fusion": {"W": W, "b": b}}},
                               jnp.asarray(X)), -1)
    yv = jnp.asarray(y, jnp.int32)
    tp = jnp.bincount(jnp.where(pred == yv, yv, C), length=C + 1)[:C]
    return np.asarray(jnp.stack([tp, jnp.bincount(yv, length=C),
                                 jnp.bincount(pred, length=C)]))


@pytest.mark.parametrize("weight", ["Simple", "Square"])
def test_loss_grads_adam_and_counts_match_jax(weight):
    V, C = 3, 4
    X, y = _points(3000, V, C, seed=1)
    rng = np.random.RandomState(2)
    W0 = (1.0 + 0.3 * rng.randn(V, C)).astype(np.float32)
    b0 = (0.1 * rng.randn(1, C)).astype(np.float32)
    params = {"fusion": {"W": jnp.asarray(W0), "b": jnp.asarray(b0)}}
    jfm = JFusion(n_inputs=V, n_classes=C)
    jloss_obj = JGDL(type_weight=weight)
    Xj, yj = jnp.asarray(X), jnp.asarray(y, jnp.int32)

    def loss_fn(p):
        out = jfm.apply({"params": p}, Xj)
        return (jloss_obj(yj[None, :, None], out[None])
                + FusionLayer.regularizer(p))

    tx = optax.adam(1e-2)
    state = tx.init(params)
    fm = FusionModel(V, C, params={"fusion": {"W": W0, "b": b0}})
    opt = Adam(fm.parameters(), 1e-2)
    loss_obj = SparseGeneralizedDiceLoss(type_weight=weight)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y.astype(np.int32))
    for _ in range(3):
        jl, grads = jax.value_and_grad(loss_fn)(params)
        loss = loss_obj(yt[None, :, None], fm(Xt)[None]) + fm.regularizer()
        opt.zero_grad()
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jl), rtol=0, atol=1e-6)
        np.testing.assert_allclose(fm.W.grad.numpy(),
                                   np.asarray(grads["fusion"]["W"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(fm.b.grad.numpy(),
                                   np.asarray(grads["fusion"]["b"]),
                                   rtol=0, atol=1e-6)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        opt.step()
        tree = params_tree(fm.W, fm.b)
        np.testing.assert_allclose(tree["fusion"]["W"],
                                   np.asarray(params["fusion"]["W"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tree["fusion"]["b"],
                                   np.asarray(params["fusion"]["b"]),
                                   rtol=0, atol=1e-6)
    got = t_train_fusion.val_counts(fm, Xt, yt, C).numpy()
    want = _jax_counts(params["fusion"]["W"], params["fusion"]["b"], X, y, C)
    np.testing.assert_array_equal(got, want)
    assert got[1].sum() == len(y)


class _Args:
    def __init__(self, **kw):
        self.__dict__.update(dict(batch_size=2 ** 17, epochs=30,
                                  early_stopping=3, learning_rate=1e-3,
                                  dice_weight="Simple"), **kw)


def _epoch_lines(log):
    return [m for m in log if m.lstrip().startswith("epoch ")]


@pytest.mark.parametrize("kw", [
    dict(learning_rate=0.05, epochs=12, early_stopping=2),
    dict(learning_rate=1e-3, epochs=4, early_stopping=3,
         dice_weight="Uniform"),
])
def test_fit_fusion_matches_jax(kw):
    """One batch per epoch (batch_size >= n_tr): the GDL is a sum over the
    batch's voxels, so the two packages' different epoch permutations do
    not matter. The same numpy seed gives the same split, the same
    val_dice per epoch (1e-6), the same early-stopping epoch (both
    configurations stop early), the same best weights (1e-5) and the same
    next numpy draw."""
    V, C = 3, 4
    X, y = _points(4000, V, C, seed=3)
    args = _Args(**kw)
    init = {"fusion": {"W": np.ones((V, C), np.float32),
                       "b": np.zeros((1, C), np.float32)}}
    logs, outs, nxt = {}, {}, {}
    for name, fit, data in (
            ("jax", j_train_fusion._fit_fusion, (X, y)),
            ("port", t_train_fusion._fit_fusion,
             (torch.from_numpy(X), torch.from_numpy(y)))):
        np.random.seed(11)
        logs[name] = []
        outs[name] = fit(*data, V, C, args, logs[name].append,
                         init_params=init)
        nxt[name] = np.random.randint(2 ** 31)
    j_lines, t_lines = _epoch_lines(logs["jax"]), _epoch_lines(logs["port"])
    assert len(t_lines) == len(j_lines) >= 2
    for jl, tl in zip(j_lines, t_lines):
        j_dice = float(jl.split("val_dice=")[1])
        t_dice = float(tl.split("val_dice=")[1])
        assert abs(j_dice - t_dice) <= 1e-6, (jl, tl)
        # the loss as printed (5 decimals): one unit of the last digit
        assert abs(float(jl.split("loss=")[1].split()[0])
                   - float(tl.split("loss=")[1].split()[0])) <= 1.5e-5
    assert "  early stopping." in logs["jax"]
    assert "  early stopping." in logs["port"]
    for key in ("W", "b"):
        np.testing.assert_allclose(outs["port"]["fusion"][key],
                                   np.asarray(outs["jax"]["fusion"][key]),
                                   rtol=0, atol=1e-5)
    assert nxt["port"] == nxt["jax"]
    assert any("fit:" in m for m in logs["port"])


def test_fit_fusion_keeps_the_best_epoch():
    """best_params is a copy: a later, worse epoch's in-place Adam update
    does not reach the returned weights."""
    V, C = 2, 3
    X, y = _points(2000, V, C, seed=4)
    log = []
    np.random.seed(0)
    out = t_train_fusion._fit_fusion(
        torch.from_numpy(X), torch.from_numpy(y), V, C,
        _Args(learning_rate=1.0, epochs=6, early_stopping=6, batch_size=256),
        log.append)
    dices = [float(m.split("val_dice=")[1]) for m in _epoch_lines(log)]
    best = int(np.argmax(dices))
    assert best < len(dices) - 1, dices  # a later epoch was worse
    fm = FusionModel(V, C, params=out)
    np.random.seed(0)
    perm = np.random.permutation(len(y))
    n_val = int(0.2 * len(y))
    Xv = torch.from_numpy(X[perm[:n_val]])
    yv = torch.from_numpy(y[perm[:n_val]].astype(np.int32))
    tp, rel, sel = t_train_fusion.val_counts(fm, Xv, yv, C).numpy() \
        .astype(np.float64)
    dice = np.nanmean((2 * tp / (rel + sel))[1:])
    assert abs(dice - dices[best]) <= 5e-6  # the log's 5 decimals


# ------------------------------------------------ mp train_fusion, e2e
@pytest.fixture(scope="module")
def projects(tmp_path_factory):
    """One tiny trained-looking project (toy data 24^3, 4 classes, 2
    views, random JAX UNet weights) made by the port's toy_data and
    init_project, copied for each package."""
    root = tmp_path_factory.mktemp("fusion_e2e")
    t_toy_data.entry_func(["--out_dir", str(root / "data"), "--N_train", "2",
                           "--N_val", "2", "--N_test", "1", "--image_size",
                           "24", "--seed", "2"])
    t_init_project.entry_func(["--name", "proj", "--root", str(root),
                               "--data_dir", str(root / "data")])
    proj = root / "proj"
    text = (proj / "train_hparams.yaml").read_text()
    for old, new in (("n_classes: Null", "n_classes: 4"),
                     ("n_channels: Null", "n_channels: 1"),
                     ("dim: Null", f"dim: {DIM}\n  init_filters: 8"),
                     ("depth: 4", "depth: 2"),
                     ("complexity_factor: 2", "complexity_factor: 1"),
                     ("real_space_span: Null", "real_space_span: 24"),
                     ("mixed_precision: True", "mixed_precision: False")):
        assert old in text, old
        text = text.replace(old, new)
    (proj / "train_hparams.yaml").write_text(text)
    np.savez(proj / "views.npz", jgeo.sample_random_views_with_angle_restriction(
        2, 60, rng=np.random.RandomState(3)))
    _jax_unet_checkpoint(proj / "model" / "@epoch_02_val_dice_0.50000.npz", 4,
                         seed=1, sharpen=4.0)
    out = {}
    for name in ("jax", "port"):
        out[name] = root / name
        shutil.copytree(proj, out[name])
    return out


ARGS = ["--overwrite", "--images_per_round", "2", "--min_val_images", "3",
        "--epochs", "3", "--batch_size", "8192", "--n_planes", "same",
        "--seed", "0"]


def _run(entry, *args):
    cwd = os.getcwd()
    try:
        return entry(list(args))
    finally:
        os.chdir(cwd)


def test_mp_train_fusion_both_packages(projects):
    """Both packages' `mp train_fusion` on copies of one project: equal
    npz keys, shapes and meta (2 rounds over 2 val + 1 random train
    image); each package's `mp predict` reads the other's file; existing
    output without --overwrite raises; --num_devices 2 raises the named
    error."""
    jp, tp = projects["jax"], projects["port"]
    _run(j_train_fusion.entry_func, "--project_dir", str(jp), *ARGS)
    params = _run(t_mp.entry_func, "train_fusion", "--project_dir", str(tp),
                  "--device", "cpu", *ARGS)
    name = "@epoch_02_val_dice_0.50000_fusion_weights.npz"
    files = {k: p / "model" / "fusion_weights" / name
             for k, p in projects.items()}
    with np.load(files["jax"]) as j, np.load(files["port"]) as t:
        assert sorted(j.files) == sorted(t.files) == [
            "__meta__", "params/fusion/W", "params/fusion/b"]
        for k in ("params/fusion/W", "params/fusion/b"):
            assert j[k].shape == t[k].shape and t[k].dtype == np.float32
            assert np.isfinite(t[k]).all()
    (jparams, _, jmeta), (tparams, _, tmeta) = (
        tckpt.load_weights(files["jax"]), tckpt.load_weights(files["port"]))
    assert jmeta == tmeta == {"round": 2, "n_views": 2}
    assert tparams["fusion"]["W"].shape == (2, 4)
    np.testing.assert_array_equal(params["fusion"]["W"],
                                  tparams["fusion"]["W"])
    log = (tp / "logs" / "train_fusion.txt").read_text()
    assert "Adding 1 random training images" in log
    assert log.count("Mapping views over") == 3
    assert "best fusion val_dice" in log and "Fusion training complete" in log

    # Each package's mp predict on the other's fusion file
    swapped = {"jax": files["port"], "port": files["jax"]}
    for k, src in swapped.items():
        shutil.copy(src, files[k])
    _run(j_predict.entry_func, "--project_dir", str(jp), "--out_dir", "pred",
         "--overwrite", "--num_devices", "1", "--n_planes", "same")
    _run(t_mp.entry_func, "predict", "--project_dir", str(tp), "--out_dir",
         "pred", "--overwrite", "--device", "cpu", "--n_planes", "same")
    for p in (jp, tp):
        assert f"Loaded fusion weights from {files[p.name]}" in (
            p / "pred" / "predict_log.txt").read_text()
        assert (p / "pred" / "csv" / "results.csv").exists()

    with pytest.raises(RuntimeError, match="exists"):
        _run(t_mp.entry_func, "train_fusion", "--project_dir", str(tp),
             "--device", "cpu")
    with pytest.raises(TooFewDevicesError, match="2 devices asked"):
        _run(t_mp.entry_func, "train_fusion", "--project_dir", str(tp),
             "--num_devices", "2")
