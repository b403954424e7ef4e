"""The port's UNet3D against the JAX package's, on the same weights carried
through the checkpoint format and the same seeded numpy inputs: the eval
forward, the train-mode forward with its new BatchNorm statistics, one
float32 Adam step, the eval step's loss and counts on 3D batches, the
checkpoint round trip port -> flax -> port, glorot_init on Conv3d and the
model build from a project's build group."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiplanarunet_tpu.evaluate.losses import (
    SparseCategoricalCrossentropy as JSCE,
)
from multiplanarunet_tpu.evaluate.metrics import METRICS as JMETRICS
from multiplanarunet_tpu.models import checkpoint as jckpt
from multiplanarunet_tpu.models.unet3d import UNet3D as JUNet3D
from multiplanarunet_tpu.train import train_step as jts
from multiplanarunet_tpu.train.utils import init_optimizer as j_init_opt
from multiplanarunet_tpu_torch.evaluate.losses import (
    SparseCategoricalCrossentropy,
)
from multiplanarunet_tpu_torch.evaluate.metrics import METRICS
from multiplanarunet_tpu_torch.models import checkpoint as tckpt
from multiplanarunet_tpu_torch.models.model_init import (
    UnsupportedModelError,
    build_model,
    model_initializer,
)
from multiplanarunet_tpu_torch.models.unet import glorot_init
from multiplanarunet_tpu_torch.models.unet3d import UNet3D
from multiplanarunet_tpu_torch.train.train_step import EvalStep, TrainStep
from multiplanarunet_tpu_torch.train.utils import init_optimizer
from tests.torch_projects import torch_threads  # noqa: F401


# the tiny 3D model: n_classes 3, depth 2, init_filters 4 (dim 16)
KW = dict(n_classes=3, n_channels=1, depth=2, init_filters=4)
LR = 1e-3


def _variables(jmodel, d, seed=0):
    """flax variables of jmodel's own tree (traced by eval_shape, no
    compile): glorot-uniform kernels, random biases and BN parameters and
    statistics, so every leaf's mapping is exercised."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, d, d, d, jmodel.n_channels)),
        train=False))
    rng = np.random.RandomState(seed)

    def param(s):
        if len(s.shape) > 1:  # a kernel (*k, I, O)
            lim = np.sqrt(6.0 / (np.prod(s.shape[:-1]) + s.shape[-1]))
            return rng.uniform(-lim, lim, s.shape).astype(np.float32)
        return (0.05 * rng.randn(*s.shape)).astype(np.float32)

    params = jax.tree.map(param, shapes["params"])
    stats = jax.tree.map(
        lambda s: (0.2 * rng.rand(*s.shape)).astype(np.float32),
        shapes["batch_stats"])
    # BN scales near 1 and variances near 1, as a trained model has
    params = _plus_one(params, "scale")
    stats = _plus_one(stats, "var")
    return params, stats


def _plus_one(tree, leaf):
    return {k: (_plus_one(v, leaf) if isinstance(v, dict)
                else v + 1.0 if k == leaf else v) for k, v in tree.items()}


def _port(params, stats, **kw):
    model = UNet3D(**{**KW, **kw})
    model.load_state_dict(tckpt.unet_state_dict_from_jax(params, stats,
                                                         model))
    return model


def _batch(seed, d, n=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d, d, d, 1).astype(np.float32)
    y = rng.randint(0, 3, (n, d, d, d, 1)).astype(np.int32)
    w = (rng.rand(n) + 0.3).astype(np.float32)
    return x, y, w


def _flat(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ncdhw(x):
    return torch.from_numpy(x).movedim(-1, 1)


# d = 18 pools to 9 and 4: both decoder levels crop their skip
@pytest.mark.parametrize("cf,d", [(1.0, 16), (2.0, 18)])
def test_unet3d_eval_forward_matches_flax(cf, d):
    """Softmax within 1e-5 from the same (random) weights; label_crop
    equal to the flax model's sown one."""
    jmodel = JUNet3D(dim=d, complexity_factor=cf, **KW)
    params, stats = _variables(jmodel, d)
    model = _port(params, stats, complexity_factor=cf).eval()
    x, _, _ = _batch(1, d)
    want, inter = jmodel.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x), train=False,
                               mutable=["intermediates"])
    with torch.no_grad():
        got = model(_ncdhw(x)).movedim(1, -1).numpy()
    # d = 18 pools to 9 and 4 and comes back as 16
    e = d - d % 4
    assert got.shape == want.shape == (2, e, e, e, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(
        model.label_crop, np.asarray(inter["intermediates"]["label_crop"][0]))
    assert model.label_crop.shape == (3, 2)
    assert model.label_crop.any() == (d % 4 != 0)


@pytest.mark.parametrize("cf,d", [(1.0, 16), (2.0, 18)])
def test_unet3d_train_mode_forward_and_bn_stats_match_flax(cf, d):
    """The new running mean/var within 1e-5; train-mode probabilities
    within 2e-5. Both frameworks normalise with float32 batch statistics
    reduced over d^3 voxels in their own order, and each lies up to about
    1e-5 from the same forward with float64 statistics at these shapes, so
    the two differ by up to twice that (the 2D model's planes reduce fewer
    pixels and meet 1e-5)."""
    jmodel = JUNet3D(dim=d, complexity_factor=cf, **KW)
    params, stats = _variables(jmodel, d, seed=2)
    model = _port(params, stats, complexity_factor=cf).train()
    x, _, _ = _batch(3, d)
    out, mutated = jmodel.apply({"params": params, "batch_stats": stats},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats", "intermediates"])
    with torch.no_grad():
        got = model(_ncdhw(x)).movedim(1, -1).numpy()
    np.testing.assert_allclose(got, np.asarray(out), atol=2e-5)
    _, new_stats = tckpt.unet_variables_from_model(model)
    want, got_s = _flat(mutated["batch_stats"]), _flat(new_stats)
    assert set(got_s) == set(want)
    for k in want:
        np.testing.assert_allclose(got_s[k], want[k], atol=1e-5, err_msg=k)


def test_unet3d_one_adam_step_matches_make_train_step():
    """One float32 Adam step: loss within 1e-6 relative, BN statistics
    within 1e-5, every parameter within 2 lr of the JAX one (a gradient
    near 0 may take either sign in Adam's first step) and 99.9% within
    1e-3 lr, as for the 2D model."""
    d = 16
    jmodel = JUNet3D(dim=d, **KW)
    params, stats = _variables(jmodel, d, seed=3)
    x, y, w = _batch(4, d)
    tx = j_init_opt("Adam", lr=LR)
    state = jts.create_train_state({"params": params, "batch_stats": stats},
                                   tx)
    step = jts.make_train_step(
        jmodel, tx, JSCE(),
        {"sparse_categorical_accuracy":
         JMETRICS["sparse_categorical_accuracy"]}, donate=False)
    new_state, jlogs = step(state, jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(w))

    model = _port(params, stats)
    opt = init_optimizer("Adam", model.parameters(), lr=LR)
    tstep = TrainStep(model, opt, SparseCategoricalCrossentropy(),
                      {"sparse_categorical_accuracy":
                       METRICS["sparse_categorical_accuracy"]})
    logs = tstep(torch.from_numpy(x), torch.from_numpy(y), w)
    np.testing.assert_allclose(logs["loss"].item(), float(jlogs["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(
        logs["sparse_categorical_accuracy"].item(),
        float(jlogs["sparse_categorical_accuracy"]), atol=1e-6)
    new_params, new_stats = tckpt.unet_variables_from_model(model)
    want_s = _flat(new_state.batch_stats)
    for k, v in _flat(new_stats).items():
        np.testing.assert_allclose(v, want_s[k], atol=1e-5, err_msg=k)
    want_p, got_p = _flat(new_state.params), _flat(new_params)
    diffs = np.concatenate([np.abs(got_p[k] - want_p[k]).ravel()
                            for k in want_p])
    assert diffs.max() <= 2 * LR
    assert (diffs <= 1e-3 * LR).mean() >= 0.999


def test_unet3d_eval_step_loss_and_counts_match_jax():
    """The eval step on a 3D batch: loss within 1e-6 relative, the int32
    per-class (tp, rel, sel) counts equal."""
    d = 16
    jmodel = JUNet3D(dim=d, **KW)
    params, stats = _variables(jmodel, d, seed=5)
    x, y, w = _batch(6, d, n=3)
    metric = {"sparse_fg_recall": JMETRICS["sparse_fg_recall"]}
    jlogs, jcounts = jts.make_eval_step(jmodel, JSCE(), metric, 3)(
        params, stats, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    ev = EvalStep(_port(params, stats), SparseCategoricalCrossentropy(),
                  {"sparse_fg_recall": METRICS["sparse_fg_recall"]}, 3)
    logs, counts = ev(torch.from_numpy(x), torch.from_numpy(y), w)
    for a, b in zip(counts, jcounts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(logs["loss"].item(), float(jlogs["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(logs["sparse_fg_recall"].item(),
                               float(jlogs["sparse_fg_recall"]), atol=1e-6)


def test_unet3d_checkpoint_round_trip_port_flax_port(tmp_path):
    """A port-initialised, port-trained UNet3D saved by the port: the
    JAX package reads it (DHWIO kernels, flax keys and shapes of its own
    init) and its UNet3D gives the port's outputs within 1e-5; the port
    reads the file back bit-exactly."""
    d = 16
    model = glorot_init(UNet3D(**KW), seed=7, device="cpu")
    opt = init_optimizer("Adam", model.parameters(), lr=LR)
    x, y, w = _batch(8, d)
    TrainStep(model, opt, SparseCategoricalCrossentropy(), {})(
        torch.from_numpy(x), torch.from_numpy(y), w)
    path = tmp_path / "model_weights.npz"
    tckpt.save_unet_weights(path, model, meta={"epoch": 1})
    params, stats, meta = jckpt.load_weights(path)
    assert meta == {"epoch": 1}
    jmodel = JUNet3D(dim=d, **KW)
    ref_params, ref_stats = _variables(jmodel, d)
    assert ({k: v.shape for k, v in _flat(params).items()}
            == {k: v.shape for k, v in _flat(ref_params).items()})
    assert set(_flat(stats)) == set(_flat(ref_stats))
    want = np.asarray(jmodel.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(x), train=False))
    model.eval()
    with torch.no_grad():
        got = model(_ncdhw(x)).movedim(1, -1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    back = _port(*tckpt.load_weights(path)[:2])
    for (k, a), b in zip(model.state_dict().items(),
                         back.state_dict().values()):
        assert torch.equal(a, b), k


def test_glorot_init_covers_conv3d_and_batchnorm3d():
    """Every Conv3d kernel glorot-uniform: inside +-sqrt(6 / (k^3 (cin +
    cout))) with the uniform's variance; biases zero; BatchNorm3d at
    identity (torch's kaiming default would miss both)."""
    model = UNet3D(n_classes=4, n_channels=1, depth=2, init_filters=16)
    for mod in model.modules():  # start from non-init values
        if isinstance(mod, torch.nn.BatchNorm3d):
            mod.running_mean.fill_(3.0)
            mod.weight.data.fill_(2.0)
    glorot_init(model, seed=1, device="cpu")
    n_conv = 0
    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv3d):
            n_conv += 1
            o, i, kd, kh, kw = mod.weight.shape
            lim = np.sqrt(6.0 / (kd * kh * kw * (i + o)))
            assert mod.weight.abs().max() <= lim
            if mod.weight.numel() > 2000:
                np.testing.assert_allclose(mod.weight.var().item(),
                                           lim ** 2 / 3, rtol=0.1)
            assert not mod.bias.any()
        elif isinstance(mod, torch.nn.BatchNorm3d):
            assert (mod.weight == 1).all() and (mod.running_mean == 0).all()
    assert n_conv == 2 * 5 + 2 + 1
    a = glorot_init(UNet3D(**KW), seed=2, device="cpu").state_dict()
    b = glorot_init(UNet3D(**KW), seed=2, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_build_model_and_initializer_build_unet3d(tmp_path):
    """build_model takes the JAX package's fields of the build group for
    UNet3D (the 3D preset's keys; unknown keys ignored), bf16 under mixed
    precision; model_initializer restores a JAX-written 3D checkpoint by
    name."""
    build = dict(model_class_name="UNet3D", dim=16, n_classes=3,
                 n_channels=1, complexity_factor=1, out_activation="softmax",
                 l1_reg=False, l2_reg=False, biased_output_layer=True,
                 depth=2, init_filters=4, dilated_upconv=False)
    model = build_model(build)
    assert type(model) is UNet3D and model.depth == 2 and not model.training
    assert build_model(build, mixed_precision=True).dtype == torch.bfloat16
    jmodel = JUNet3D(dim=16, **KW)
    params, stats = _variables(jmodel, 16, seed=9)
    path = tmp_path / "w.npz"
    jckpt.save_weights(path, params, stats)
    hp = {"build": build, "fit": {"mixed_precision": False}}
    restored, epoch, lr = model_initializer(hp, initialize_from=path,
                                             device="cpu")
    assert epoch == 0 and lr is None and restored.training
    want = _port(params, stats).state_dict()
    for k, v in restored.state_dict().items():
        assert torch.equal(v, want[k]), k
    multi = build_model({**build, "model_class_name": "MultiTaskUNet2D",
                         "task_names": ["a", "b"], "n_classes": [3, 4],
                         "n_channels": [1, 1], "dim": [16, 32]})
    assert type(multi).__name__ == "MultiTaskUNet2D"
    assert multi.n_classes == [3, 4] and multi.depth == 2
    # FusionModel from n_inputs and n_classes, as the JAX build_model
    # builds it: the same probabilities on the same weights
    from multiplanarunet_tpu.models.model_init import (
        build_model as j_build_model,
    )

    fusion_build = {**build, "model_class_name": "FusionModel",
                    "n_inputs": 3, "n_classes": 4}
    fusion = build_model(fusion_build, mixed_precision=True)
    jfusion = j_build_model(fusion_build, mixed_precision=True)
    rng = np.random.RandomState(4)
    fparams = {"fusion": {"W": rng.randn(3, 4).astype(np.float32),
                          "b": rng.randn(1, 4).astype(np.float32)}}
    with torch.no_grad():
        fusion.W.copy_(torch.from_numpy(fparams["fusion"]["W"]))
        fusion.b.copy_(torch.from_numpy(fparams["fusion"]["b"]))
    x = rng.rand(5, 3, 4).astype(np.float32)
    want = np.asarray(jfusion.apply({"params": fparams}, jnp.asarray(x)))
    with torch.no_grad():
        got = fusion(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(UnsupportedModelError):
        build_model({**build, "model_class_name": "NoSuchModel"})
