"""The configuration surface the JAX package takes by name, in the port:
the sklearn scalers with their constructor arguments, the flax.linen /
jax.nn activations, the optax options and build_model's fields. The
same seeded numpy inputs go through the JAX package and the port.

Tolerances: the scalers' outputs are equal (Binarizer, Normalizer,
FunctionTransformer, the encoders, the affine scalers) or within 1e-5
(PowerTransformer, its lambda within 1e-6 relative) and 1e-6
(QuantileTransformer); the activations within 1e-6 (relative past 1); the
tiny U-Nets within 1e-5 in float32."""
import warnings

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import sklearn.preprocessing as skl

from multiplanarunet_tpu.models.model_init import build_model as j_build
from multiplanarunet_tpu.models.unet import _act as j_act
from multiplanarunet_tpu.preprocessing import scaling as j_scaling
from multiplanarunet_tpu.train.utils import _OPTIMIZERS as J_OPTIMIZERS
from multiplanarunet_tpu_torch.image.image_pair import ImagePair
from multiplanarunet_tpu_torch.io import nifti
from multiplanarunet_tpu_torch.models import checkpoint as tckpt
from multiplanarunet_tpu_torch.models.model_init import build_model
from multiplanarunet_tpu_torch.models.unet import (
    NOT_ACTIVATIONS,
    UNet,
    UnsupportedActivationError,
    _ACTIVATIONS,
    flattened,
    get_activation,
)
from multiplanarunet_tpu_torch.preprocessing import scaling as t_scaling
from multiplanarunet_tpu_torch.train import optimizers as topt
from multiplanarunet_tpu_torch.train.optimizers import OPTIMIZERS
from multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict import (
    _inference_model,
)

torch.set_num_threads(2)

# The 18 names this port added, and the 11 it had
NEW_ACTIVATIONS = (
    "celu", "hard_sigmoid", "hard_silu", "hard_swish", "hard_tanh",
    "identity", "log1mexp", "log_sigmoid", "log_softmax", "mish",
    "normalize", "relu6", "soft_sign", "softmax", "sparse_plus",
    "sparse_sigmoid", "squareplus", "standardize")
# What the port refuses although the JAX package runs it, and why
ALLOWED_GAPS = {
    # optax's weight-decay mask: a callable or a pytree over flax's
    # parameter tree, which a YAML cannot express
    "mask": "optimizer",
    # flax utilities that getattr(flax.linen, name) also resolves: a
    # decorator, a decorator factory and boxing helpers, the identity on
    # an array only by accident
    **{name: "activation" for name in NOT_ACTIVATIONS},
}


def _volume(seed, shape=(9, 8, 7, 2)):
    rng = np.random.RandomState(seed)
    vol = (rng.gamma(2.0, 30.0, size=shape) - 10.0).astype(np.float32)
    vol[::3] = np.round(vol[::3] / 10.0) * 10.0  # repeated values
    return vol


def _data(name):
    vol = _volume(0)
    if "Encoder" in name:
        return np.round(vol / 25.0).astype(np.float32)  # a few categories
    return vol


def _both(name, data, ignore, kwargs):
    """(JAX scaler, port scaler, JAX output, port output) of one fit on
    `data`, each from the same numpy global random state."""
    out = []
    for mod in (j_scaling, t_scaling):
        np.random.seed(5)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            scaler = mod.get_scaler(name, ignore_less_eq=ignore, **kwargs)
            out.append((scaler, scaler.fit_transform(data)))
    (j, j_out), (t, t_out) = out
    return j, t, j_out, t_out


# ------------------------------------------------------------------ scalers
SCALER_CASES = [
    ("StandardScaler", {"with_mean": False}, 0),
    ("StandardScaler", {"with_std": False}, 0),
    ("MinMaxScaler", {"feature_range": (-1, 2), "clip": True}, 0),
    ("RobustScaler", {"with_centering": False,
                      "quantile_range": (10.0, 90.0)}, 0),
    ("RobustScaler", {"unit_variance": True, "with_scaling": True}, 0),
    ("QuantileTransformer", {"output_distribution": "normal"}, 1e-6),
    ("QuantileTransformer", {"n_quantiles": 40, "subsample": 200,
                             "random_state": 7}, 1e-6),
    ("QuantileTransformer", {"n_quantiles": 40, "subsample": 200,
                             "output_distribution": "normal"}, 1e-6),
    ("PowerTransformer", {}, 1e-5),
    ("PowerTransformer", {"standardize": False}, 1e-5),
    ("PowerTransformer", {"method": "box-cox"}, 1e-5),
    ("Normalizer", {}, 0),
    ("Normalizer", {"norm": "l1"}, 0),
    ("Normalizer", {"norm": "max"}, 0),
    ("Binarizer", {}, 0),
    ("Binarizer", {"threshold": 20.0}, 0),
    ("FunctionTransformer", {}, 0),
    ("FunctionTransformer", {"func": np.log1p, "inverse_func": np.expm1},
     0),
    ("FunctionTransformer", {"func": np.clip,
                             "kw_args": {"a_min": 0.0, "a_max": 50.0}}, 0),
    ("LabelEncoder", {}, 0),
    ("OrdinalEncoder", {}, 0),
    ("OrdinalEncoder", {"handle_unknown": "use_encoded_value",
                        "unknown_value": -1}, 0),
]


@pytest.mark.parametrize("ignore", [None, "per channel"])
@pytest.mark.parametrize(
    "name,kwargs,tol", SCALER_CASES,
    ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(SCALER_CASES)])
def test_scaler_matches_jax_package(name, kwargs, tol, ignore):
    data = _data(name)
    if kwargs.get("method") == "box-cox":
        data = data - data.min() + 1.0  # strictly positive
    if ignore is not None:
        # per channel: each keeps about its upper two thirds
        ignore = [float(np.percentile(data[..., c], 33))
                  for c in range(data.shape[-1])]
    unseen = ignore is not None and "Encoder" in name and not kwargs
    if unseen:
        # a value not seen in the fit: both packages raise at transform
        for mod in (j_scaling, t_scaling):
            with pytest.raises(ValueError):
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    mod.get_scaler(name, ignore_less_eq=ignore,
                                   **kwargs).fit_transform(data)
        return
    j, t, j_out, t_out = _both(name, data, ignore, kwargs)
    assert t_out.dtype == j_out.dtype == data.dtype
    assert t_out.shape == data.shape
    np.testing.assert_allclose(t_out, j_out, rtol=0, atol=tol,
                               equal_nan=True)
    assert (t.affine_params()[0] is None) == (j.affine_params()[0] is None)
    if name == "PowerTransformer":
        for sk, ch in zip(j.scalers, t.channels):
            assert ch.lambda_.dtype == sk.lambdas_.dtype
            np.testing.assert_allclose(ch.lambda_, sk.lambdas_[0],
                                       rtol=1e-6)
    if name == "QuantileTransformer":
        for sk, ch in zip(j.scalers, t.channels):
            np.testing.assert_array_equal(ch.quantiles_, sk.quantiles_[:, 0])


@pytest.mark.parametrize("name", sorted(t_scaling.REFUSED))
def test_scalers_neither_package_runs(name):
    """The JAX package accepts the name and fails in the fit or the
    transform; the port refuses it by name, with the reason."""
    vol = _volume(1)
    assert j_scaling.assert_scaler(name)
    assert not t_scaling.assert_scaler(name)
    with pytest.raises((ValueError, TypeError)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            j_scaling.get_scaler(name).fit_transform(vol)
    with pytest.raises(t_scaling.UnsupportedScalerError,
                       match=t_scaling.REFUSED[name][:20]):
        t_scaling.get_scaler(name).fit_transform(vol)


def test_scaler_argument_errors():
    """An argument sklearn does not have is sklearn's TypeError in both
    packages; one sklearn has and the port does not implement is a named
    UnsupportedScalerError; positional arguments go to the constructor."""
    vol = _volume(2)
    for mod in (j_scaling, t_scaling):
        with pytest.raises(TypeError):
            mod.get_scaler("Binarizer", no_such_argument=1).fit(vol)
    with pytest.raises(t_scaling.UnsupportedScalerError,
                       match="min_frequency"):
        t_scaling.get_scaler("OrdinalEncoder", min_frequency=2)
    j = j_scaling.get_scaler("PowerTransformer", "box-cox").fit_transform(
        vol - vol.min() + 1.0)
    t = t_scaling.get_scaler("PowerTransformer", "box-cox").fit_transform(
        vol - vol.min() + 1.0)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)
    # box-cox of data that is not strictly positive: sklearn's ValueError
    for mod in (j_scaling, t_scaling):
        with pytest.raises(ValueError, match="strictly positive"):
            mod.get_scaler("PowerTransformer",
                           method="box-cox").fit_transform(vol)


def test_non_affine_scaler_on_the_host_path(tmp_path):
    """An ImagePair with a non-affine scaler: the sampler's scaled volume
    and bg value are the scaler's transform, which equals the JAX
    package's fit of the same name."""
    vol = _volume(3, (12, 10, 8, 1))
    nifti.save(vol, tmp_path / "img.nii.gz", np.eye(4))
    pair = ImagePair(tmp_path / "img.nii.gz")
    pair.set_bg_value(0.5)
    pair.set_scaler("PowerTransformer")
    sampler = pair.interpolator
    want = j_scaling.get_scaler("PowerTransformer").fit_transform(pair.image)
    np.testing.assert_allclose(sampler.scaled_volume, want, atol=1e-5)
    bg = pair.scaler.transform(np.full((1, 1, 1, 1), 0.5, np.float32))
    np.testing.assert_array_equal(sampler.scaled_bg_value, bg.reshape(-1))


# -------------------------------------------------------------- activations
@pytest.mark.parametrize("name", NEW_ACTIVATIONS)
def test_activation_matches_jax(name):
    """The function over NHWC in JAX and NCHW in the port (the channel
    axis for softmax, log_softmax, standardize and normalize), within
    1e-6, NaN where JAX gives NaN (log1mexp below 0); bf16 stays bf16."""
    rng = np.random.RandomState(len(name))
    x = (rng.randn(2, 5, 4, 6) * 3.0).astype(np.float32)
    x[0, 0, 0, :] = [-1.0, 1.0, 0.0, 3.0, -3.0, 1e-7]  # the breakpoints
    want = np.asarray(j_act(name)(jnp.asarray(x)))
    fn = get_activation(name)
    got = fn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6,
                               equal_nan=True)
    assert fn(torch.ones(1, 2, 3, 3, dtype=torch.bfloat16)).dtype == \
        torch.bfloat16


def _jax_variables(jmodel, x):
    """flax variables of jmodel (traced by eval_shape, no compile) with
    glorot-scaled kernels, random biases, BN parameters and statistics."""
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x,
                                                train=False))
    rng = np.random.RandomState(0)

    def leaf(path, s):
        key = path[-1].key
        if len(s.shape) > 1:
            lim = np.sqrt(6.0 / (np.prod(s.shape[:-1]) + s.shape[-1]))
            return rng.uniform(-lim, lim, s.shape).astype(np.float32)
        if key in ("scale", "var"):
            return (1.0 + 0.2 * rng.rand(*s.shape)).astype(np.float32)
        return (0.05 * rng.randn(*s.shape)).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(leaf, shapes)
    return v["params"], v["batch_stats"]


UNET_CASES = [
    ("UNet", {"activation": "softmax"}),
    ("UNet", {"activation": "standardize", "out_activation": "sigmoid"}),
    ("UNet", {"activation": "hard_swish", "out_activation": "log_softmax",
              "padding": "valid", "flatten_output": True}),
    ("UNet3D", {"activation": "mish", "out_activation": "log_softmax",
                "flatten_output": True}),
    ("MultiTaskUNet2D", {"activation": "normalize", "padding": "valid",
                         "flatten_output": True}),
]


@pytest.mark.parametrize("cls,extra", UNET_CASES,
                         ids=[c for c, _ in UNET_CASES])
def test_tiny_unet_from_build_model_matches_jax(cls, extra):
    """build_model of each package on the same build group, the JAX
    weights carried into the port by the converter: float32 eval outputs
    within 1e-5, flattened to (B, prod(spatial), C) where the group says
    so."""
    build = {"model_class_name": cls, "depth": 2, "init_filters": 4,
             "complexity_factor": 1.0, "n_classes": 3, "n_channels": 2,
             "dim": 8, **extra}
    rng = np.random.RandomState(9)
    if cls == "MultiTaskUNet2D":
        build.update(task_names=["a", "b"], n_classes=[3, 4],
                     n_channels=[2, 2], dim=[8, 12])
        xs = [rng.randn(2, d, d, 2).astype(np.float32) for d in (8, 12)]
        x_j = tuple(jnp.asarray(x) for x in xs)
        x_t = [torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs]
    else:
        spatial = (8, 8, 8) if cls == "UNet3D" else (8, 8)
        x = rng.randn(2, *spatial, 2).astype(np.float32)
        x_j = jnp.asarray(x)
        x_t = torch.from_numpy(x).movedim(-1, 1)
    jmodel = j_build(build)
    params, stats = _jax_variables(jmodel, x_j)
    want = jmodel.apply({"params": params, "batch_stats": stats}, x_j,
                        train=False)
    model = build_model(build)
    model.load_state_dict(tckpt.unet_state_dict_from_jax(params, stats,
                                                         model))
    with torch.inference_mode():
        got = model(x_t)
    if cls != "MultiTaskUNet2D":
        want, got = [want], [got]
    for w, g in zip(want, got):
        w = np.asarray(w)
        if not extra.get("flatten_output"):
            g = g.movedim(1, -1)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)


def test_predictor_runs_a_flattened_unet_unflattened():
    """The predictor's twin of a U-Net built with flatten_output returns
    (B, C, H, W), the same values (the JAX predictor reshapes the
    flattened output back to its planes)."""
    model = UNet(n_classes=3, n_channels=1, depth=2, init_filters=4,
                 flatten_output=True).eval()
    twin = _inference_model(model)
    assert model.flatten_output and not twin.flatten_output
    x = torch.randn(2, 1, 16, 16)
    with torch.inference_mode():
        np.testing.assert_allclose(flattened(twin(x)).numpy(),
                                   model(x).numpy(), atol=1e-6)


# ------------------------------------------------------------- drift guard
def test_every_name_the_jax_package_runs_is_ported():
    """Every sklearn.preprocessing class the JAX package fits on a volume,
    every flax.linen / jax.nn name its U-Nets take as an activation (the
    name resolves and returns an array of the input's shape) and every
    optax argument its optimizers pass through is in the port, or is an
    allowed gap with its reason (ALLOWED_GAPS, t_scaling.REFUSED)."""
    vol = _volume(4)
    for name in sorted(n for n in dir(skl)
                       if isinstance(getattr(skl, n), type)):
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                j_scaling.get_scaler(name).fit_transform(vol)
        except (ValueError, TypeError):
            assert name in t_scaling.REFUSED, name
            continue
        assert t_scaling.assert_scaler(name), name

    x = jnp.asarray(np.random.RandomState(0).randn(2, 3, 3, 4), jnp.float32)
    taken = set()
    for name in sorted(set(dir(fnn)) | set(dir(jax.nn))):
        if name.startswith("_"):
            continue
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                y = j_act(name)(x)
        except Exception:  # not an activation of an array
            continue
        if isinstance(y, jax.Array) and y.shape == x.shape:
            taken.add(name)
    for name in sorted(taken):
        if ALLOWED_GAPS.get(name) == "activation":
            with pytest.raises(UnsupportedActivationError,
                               match="not an activation"):
                get_activation(name)
        else:
            assert name in _ACTIVATIONS, name
    assert set(NEW_ACTIVATIONS) <= taken
    assert {k for k in _ACTIVATIONS if k} <= taken

    import inspect

    for name, fn in J_OPTIMIZERS.items():
        missing = (set(inspect.signature(fn).parameters)
                   - set(OPTIMIZERS[name].accepted))
        assert missing <= {k for k, v in ALLOWED_GAPS.items()
                           if v == "optimizer"}, (name, missing)
        if missing:
            with pytest.raises(topt.UnsupportedOptimizerOptionError,
                               match="YAML"):
                OPTIMIZERS[name]([torch.nn.Parameter(torch.zeros(2))],
                                 1e-3, mask=lambda p: p)
