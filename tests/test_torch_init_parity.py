"""The port's initial weights against the JAX package's, bit for bit in
float32: `glorot_init`, `init_model_variables` and `init_unet` against
`multiplanarunet_tpu/models/model_init.py:init_model_variables` from the
same PRNGKey, carried through `unet_state_dict_from_jax`, for the UNet in
its plain, dilated_upconv, subpixel_decoder and lane_pad 8 forms, UNet3D
and MultiTaskUNet2D; then `model_initializer` of both packages on the
same tiny MultiPlanar, 3D and MultiTask build groups. Small widths
(depth 2, init_filters 8), the draws on the CPU."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiplanarunet_tpu.models import model_init as jinit
from multiplanarunet_tpu.models.multitask_unet import (
    MultiTaskUNet2D as JMultiTask,
)
from multiplanarunet_tpu.models.unet import UNet as JUNet
from multiplanarunet_tpu.models.unet3d import UNet3D as JUNet3D
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.models import checkpoint as tckpt
from multiplanarunet_tpu_torch.models import model_init as tinit
from multiplanarunet_tpu_torch.models.multitask_unet import MultiTaskUNet2D
from multiplanarunet_tpu_torch.models.unet import UNet, glorot_init, init_unet
from multiplanarunet_tpu_torch.models.unet3d import UNet3D
from multiplanarunet_tpu_torch.ops import prng
from tests.torch_projects import torch_threads  # noqa: F401


KW2D = dict(n_classes=3, n_channels=2, depth=2, complexity_factor=2.0,
            init_filters=8)
FORMS = {"plain": {}, "dilated_upconv": {"dilated_upconv": True},
         "subpixel_decoder": {"subpixel_decoder": True},
         "lane_pad_8": {"lane_pad": 8}}
KW3D = dict(n_classes=3, n_channels=1, depth=2, init_filters=8)
KWMT = dict(task_names=("a", "b"), n_classes=(3, 4), n_channels=(2, 2),
            depth=2, init_filters=8)
MT_DIMS = (16, 24)


def _bits(t):
    return np.ascontiguousarray(t.numpy()).view(np.uint8)


def _assert_state_equal(model, variables):
    """model's state equals the flax variables carried by the converter,
    bit for bit."""
    want = tckpt.unet_state_dict_from_jax(
        variables["params"], variables.get("batch_stats", {}), model)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(_bits(v), _bits(want[k]), err_msg=k)


def _pairs():
    """(name, port model, JAX model) for every family and form."""
    for name, form in FORMS.items():
        yield (f"unet_{name}", lambda f=form: UNet(**KW2D, **f),
               lambda f=form: JUNet(dim=16, **KW2D, **f))
    yield ("unet3d", lambda: UNet3D(**KW3D),
           lambda: JUNet3D(dim=8, **KW3D))
    yield ("multitask", lambda: MultiTaskUNet2D(dim=list(MT_DIMS), **KWMT),
           lambda: JMultiTask(dim=MT_DIMS, **KWMT))


PAIRS = {name: (port, jax_) for name, port, jax_ in _pairs()}


@functools.cache
def _jax_init(name):
    """The JAX init_model_variables of pair `name` as one jitted function
    of the key: compiled once per module, whatever the key, at XLA's
    backend optimisation level 0 (~1 s in place of ~10 s a model on the
    CPU; the draws are the same bits)."""
    jmodel = PAIRS[name][1]()
    return jax.jit(lambda key: jinit.init_model_variables(jmodel, key),
                   compiler_options={"xla_backend_optimization_level": 0})


@functools.cache
def _jax_variables(name, key):
    """The JAX init_model_variables of pair `name` from `key` (a tuple of
    the raw key's two words), computed once per module."""
    return _jax_init(name)(jnp.asarray(key, jnp.uint32))


def _key(seed):
    return tuple(int(w) for w in prng.PRNGKey(seed))


@pytest.mark.parametrize("name,seed", [(n, 0) for n in sorted(PAIRS)]
                         + [("unet_plain", 3)])
def test_glorot_init_equals_flax_init(name, seed):
    """glorot_init(model, seed) == the JAX init_model_variables(jmodel,
    PRNGKey(seed)) after the converter, every kernel drawn (no zero
    kernel)."""
    model = glorot_init(PAIRS[name][0](), seed, device="cpu")
    _assert_state_equal(model, _jax_variables(name, _key(seed)))
    kernels = [v for k, v in model.state_dict().items() if v.dim() >= 4]
    assert kernels and all(k.abs().max() > 0 for k in kernels)


@pytest.mark.parametrize("name", ["unet_plain", "unet_lane_pad_8",
                                  "unet3d", "multitask"])
def test_init_model_variables_equals_jax(name):
    """The port's init_model_variables(model, key) returns the JAX
    function's tree: the same collections, paths and shapes, each leaf
    equal; its default key is PRNGKey(0), as there. init_unet gives its
    (params, batch_stats)."""
    key = tuple(int(w) for w in jax.random.fold_in(jax.random.PRNGKey(9), 2))
    for tkey, jkey in ((np.asarray(key, np.uint32), key), (None, _key(0))):
        want = _jax_variables(name, jkey)
        got = tinit.init_model_variables(PAIRS[name][0](), tkey,
                                         device="cpu")
        assert set(got) == set(want) == {"params", "batch_stats"}
        for coll in got:
            w, g = tckpt.flatten(dict(want[coll])), tckpt.flatten(got[coll])
            assert set(g) == set(w), coll
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    params, stats = init_unet(PAIRS[name][0](), np.asarray(key, np.uint32),
                              device="cpu")
    got = tinit.init_model_variables(PAIRS[name][0](),
                                     np.asarray(key, np.uint32), device="cpu")
    for a, b in ((params, got["params"]), (stats, got["batch_stats"])):
        fa, fb = tckpt.flatten(a), tckpt.flatten(b)
        assert set(fa) == set(fb)
        for k in fb:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_init_model_variables_fusion_model_is_constant():
    from multiplanarunet_tpu.models.fusion_model import (
        FusionModel as JFusion,
    )
    from multiplanarunet_tpu_torch.models.fusion_model import FusionModel

    want = jinit.init_model_variables(JFusion(n_inputs=3, n_classes=4))
    got = tinit.init_model_variables(FusionModel(3, 4), device="cpu")
    for leaf in ("W", "b"):
        np.testing.assert_array_equal(
            got["params"]["fusion"][leaf].numpy(),
            np.asarray(want["params"]["fusion"][leaf]))


BUILDS = {
    "MultiPlanar": dict(model_class_name="UNet", dim=16, **KW2D,
                        out_activation="softmax", l2_reg=False),
    "MultiPlanar_lane_pad": dict(model_class_name="UNet", dim=16, **KW2D,
                                 lane_pad=8),
    "3D": dict(model_class_name="UNet3D", dim=8, **KW3D),
    "MultiTask": dict(model_class_name="MultiTaskUNet2D", dim=list(MT_DIMS),
                      **{**KWMT, "task_names": list(KWMT["task_names"]),
                         "n_classes": list(KWMT["n_classes"]),
                         "n_channels": list(KWMT["n_channels"])}),
}


@pytest.mark.parametrize("preset,mixed", [(p, False) for p in sorted(BUILDS)]
                         + [("MultiPlanar", True)])
def test_model_initializer_starts_where_jax_starts(preset, mixed):
    """Both packages' model_initializer on the same build group (and
    mixed_precision): the port's fresh model holds the JAX package's
    fresh variables, bit for bit."""
    hp = {"build": dict(BUILDS[preset]),
          "fit": {"mixed_precision": mixed}}
    _, variables, epoch, _ = jinit.model_initializer(
        {"build": dict(BUILDS[preset]), "fit": dict(hp["fit"])},
        logger=lambda *a, **k: None)
    model, t_epoch, lr = tinit.model_initializer(
        hp, logger=ScreenLogger(False), device="cpu")
    assert epoch == t_epoch == 0 and lr is None and model.training
    _assert_state_equal(model, variables)


def test_scope_keys_follow_the_module_paths():
    """Two kernels of one model draw from different keys, and a model of
    other widths keeps each kernel's key (its first values agree where
    the shapes share a prefix of the flat stream)."""
    a = init_unet(UNet(**KW2D), prng.PRNGKey(0), device="cpu")[0]
    b = init_unet(UNet(**{**KW2D, "n_classes": 5}), prng.PRNGKey(0),
                  device="cpu")[0]
    k1 = a["encoder_L0"]["conv1"]["kernel"]
    k2 = a["encoder_L0"]["conv2"]["kernel"]
    assert not torch.equal(k1.flatten()[:50], k2.flatten()[:50])
    assert torch.equal(k1, b["encoder_L0"]["conv1"]["kernel"])
