"""The port's training step against the JAX package's, from the same
weights (carried with the checkpoint format) and the same seeded batch:
the train-mode UNet forward and its new BatchNorm statistics against flax
`apply(train=True, mutable=...)`, one float32 Adam step against
`make_train_step`, the L1/L2 penalty, the eval step's counts, and weight
files written by the port read by the JAX package."""
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
from multiplanarunet_tpu.models.unet import UNet as JUNet
from multiplanarunet_tpu.train import train_step as jts
from multiplanarunet_tpu.train.utils import init_optimizer as j_init_opt
from multiplanarunet_tpu_torch.evaluate.losses import (
    SparseCategoricalCrossentropy,
)
from multiplanarunet_tpu_torch.evaluate.metrics import METRICS
from multiplanarunet_tpu_torch.models import checkpoint as tckpt
from multiplanarunet_tpu_torch.models.unet import UNet, glorot_init
from multiplanarunet_tpu_torch.train.train_step import (
    EvalStep,
    TrainStep,
    reg_penalty,
)
from multiplanarunet_tpu_torch.train.utils import init_optimizer
from tests.torch_projects import flax_init, torch_threads  # noqa: F401


KW = dict(n_classes=4, n_channels=2, depth=2, init_filters=8)
LR = 1e-3


def _variables(jmodel, hw, seed=0):
    """flax variables with random running statistics."""
    v = flax_init(jmodel, jax.random.PRNGKey(seed), (1, hw, hw, 2))
    params = jax.tree.map(np.asarray, v["params"])
    rng = np.random.RandomState(seed)
    stats = jax.tree.map(
        lambda s: (np.asarray(s) + 0.2 * rng.rand(*s.shape)).astype(
            np.float32), v["batch_stats"])
    return params, stats


def _port(params, stats, **kw):
    model = UNet(**{**KW, **kw})
    model.load_state_dict(tckpt.unet_state_dict_from_jax(params, stats,
                                                         model))
    return model


def _batch(seed, hw, n=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, hw, hw, 2).astype(np.float32)
    y = rng.randint(0, 4, (n, hw, hw, 1)).astype(np.int32)
    w = (rng.rand(n) + 0.3).astype(np.float32)
    return x, y, w


def _flat_stats(tree):
    """{'a/b/leaf': array} of a nested dict of arrays."""
    return {"/".join(str(p.key) for p in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("cf,hw", [(1.0, 32), (2.0, 30)])
def test_train_mode_forward_and_bn_stats_match_flax(cf, hw):
    """Train-mode probabilities within 1e-5, new running mean/var within
    1e-5, label_crop equal (hw=30 crops both decoder levels)."""
    jmodel = JUNet(dim=hw, complexity_factor=cf, **KW)
    params, stats = _variables(jmodel, hw)
    model = _port(params, stats, complexity_factor=cf).train()
    x, _, _ = _batch(1, hw)
    out, mutated = jmodel.apply({"params": params, "batch_stats": stats},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats", "intermediates"])
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(out), atol=1e-5)
    _, new_stats = tckpt.unet_variables_from_model(model)
    want = _flat_stats(mutated["batch_stats"])
    got_stats = _flat_stats(new_stats)
    assert set(got_stats) == set(want)
    for k in want:
        np.testing.assert_allclose(got_stats[k], want[k], atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(
        model.label_crop, np.asarray(mutated["intermediates"]["label_crop"][0]))
    assert model.label_crop.any() == (hw % 4 != 0)


def test_one_adam_step_matches_make_train_step():
    """One float32 Adam step (lr 1e-3, eps 1e-7): loss within 1e-6
    relative, BN running statistics within 1e-5, metric equal to 1e-6.
    Parameters: Adam's first step is -lr * g / (|g| + eps), so a gradient
    near 0 takes any value in [-lr, lr] and rounding can flip it; every
    parameter is within 2 lr of the JAX one and at least 99.9% within
    1e-3 lr."""
    hw = 32
    jmodel = JUNet(dim=hw, **KW)
    params, stats = _variables(jmodel, hw, seed=3)
    x, y, w = _batch(4, hw, n=4)
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
    want_s = _flat_stats(new_state.batch_stats)
    for k, v in _flat_stats(new_stats).items():
        np.testing.assert_allclose(v, want_s[k], atol=1e-5, err_msg=k)
    want_p = _flat_stats(new_state.params)
    got_p = _flat_stats(new_params)
    start = _flat_stats(params)
    diffs = np.concatenate([np.abs(got_p[k] - want_p[k]).ravel()
                            for k in want_p])
    moved = np.concatenate([np.abs(want_p[k] - start[k]).ravel()
                            for k in want_p])
    assert moved.max() <= LR * 1.0001 and np.median(moved) > 0.5 * LR
    assert diffs.max() <= 2 * LR
    assert (diffs <= 1e-3 * LR).mean() >= 0.999, (diffs <= 1e-3 * LR).mean()


def test_reg_penalty_matches_jax():
    jmodel = JUNet(dim=16, **KW)
    params, stats = _variables(jmodel, 16)
    model = _port(params, stats)
    for l1, l2 in ((0.0, 0.0), (1e-4, 0.0), (0.0, 3e-4), (2e-4, 1e-3)):
        want = float(jts._reg_penalty(jax.tree.map(jnp.asarray, params), l1,
                                      l2))
        got = reg_penalty(list(model.parameters()), l1, l2)
        np.testing.assert_allclose(float(got.detach()) if l1 or l2 else got,
                                   want, rtol=1e-6)


def test_eval_step_counts_equal_jax():
    hw = 32
    jmodel = JUNet(dim=hw, **KW)
    params, stats = _variables(jmodel, hw, seed=5)
    x, y, w = _batch(6, hw, n=4)
    y[0, :3, :3] = 9  # labels outside the classes count nowhere
    metric = {"sparse_fg_recall": JMETRICS["sparse_fg_recall"]}
    jlogs, jcounts = jts.make_eval_step(jmodel, JSCE(), metric, 4)(
        params, stats, jnp.asarray(x), jnp.asarray(np.minimum(y, 3)),
        jnp.asarray(w))
    _, jcounts_raw = jts.make_eval_step(jmodel, JSCE(), {}, 4)(
        params, stats, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    model = _port(params, stats)
    ev = EvalStep(model, SparseCategoricalCrossentropy(),
                  {"sparse_fg_recall": METRICS["sparse_fg_recall"]}, 4)
    logs, counts = ev(torch.from_numpy(x),
                      torch.from_numpy(np.minimum(y, 3)), w)
    for a, b in zip(counts, jcounts):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(logs["loss"].item(), float(jlogs["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(logs["sparse_fg_recall"].item(),
                               float(jlogs["sparse_fg_recall"]), atol=1e-6)
    _, counts_raw = EvalStep(model, SparseCategoricalCrossentropy(), {}, 4)(
        torch.from_numpy(x), torch.from_numpy(np.minimum(y, 3)), w)
    _, counts_raw = ev.__class__(model, lambda *a, **k: torch.zeros(()), {},
                                 4)(torch.from_numpy(x), torch.from_numpy(y),
                                    w)
    for a, b in zip(counts_raw, jcounts_raw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not model.training


def test_port_weights_load_in_jax_and_back(tmp_path):
    """A port-initialised, port-trained model saved by the port: the JAX
    package's load_weights reads it and its UNet gives the port's outputs
    (within 1e-5); the port reads the file back bit-exactly."""
    model = glorot_init(UNet(**KW), seed=7, device="cpu")
    opt = init_optimizer("Adam", model.parameters(), lr=LR)
    step = TrainStep(model, opt, SparseCategoricalCrossentropy(), {})
    x, y, w = _batch(8, 16)
    step(torch.from_numpy(x), torch.from_numpy(y), w)
    path = tmp_path / "model_weights.npz"
    tckpt.save_unet_weights(path, model, meta={"epoch": 3})
    params, stats, meta = jckpt.load_weights(path)
    assert meta == {"epoch": 3}
    jmodel = JUNet(dim=16, **KW)
    want = np.asarray(jmodel.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(x), train=False))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5)
    back = _port(*tckpt.load_weights(path)[:2])
    for (k, a), b in zip(model.state_dict().items(),
                         back.state_dict().values()):
        assert torch.equal(a, b), k
    # the flax init's shapes, key for key
    jp, _ = _variables(jmodel, 16)
    assert ({k: v.shape for k, v in _flat_stats(jp).items()}
            == {k: v.shape for k, v in _flat_stats(params).items()})


def test_glorot_init_matches_flax_statistics():
    """glorot-uniform kernels: every conv kernel inside +-sqrt(6 / (fan_in +
    fan_out)) with the uniform's variance, biases zero, BN at identity."""
    model = glorot_init(UNet(n_classes=4, n_channels=1, depth=2,
                             init_filters=16), seed=1, device="cpu")
    for name, p in model.named_parameters():
        if p.dim() == 4:
            o, i, kh, kw = p.shape
            lim = np.sqrt(6.0 / (kh * kw * (i + o)))
            assert p.abs().max() <= lim
            if p.numel() > 2000:
                np.testing.assert_allclose(p.var().item(), lim ** 2 / 3,
                                           rtol=0.1)
        elif name.endswith("bias"):
            assert not p.any(), name
    a = glorot_init(UNet(**KW), seed=2, device="cpu").state_dict()
    b = glorot_init(UNet(**KW), seed=2, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_bf16_step_close_to_f32_and_overfits():
    """The mixed-precision step (bf16 convolutions) computes the float32
    step's loss within 2e-2 relative; 50 bf16 Adam steps (lr 1e-3) on one
    fixed batch bring the loss below half its first value."""
    x, y, w = _batch(9, 32, n=4)
    y = (x[..., :1] > 0.3).astype(np.int32) + (x[..., 1:] > 0.8)
    losses = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = glorot_init(UNet(**KW, dtype=dtype), seed=4,
                            device="cpu")
        opt = init_optimizer("Adam", model.parameters(), lr=1e-3)
        step = TrainStep(model, opt, SparseCategoricalCrossentropy(), {})
        losses[dtype] = [step(torch.from_numpy(x), torch.from_numpy(y),
                              w)["loss"].item()
                         for _ in range(1 if dtype == torch.float32 else 50)]
    f32, bf16 = losses[torch.float32][0], losses[torch.bfloat16]
    assert abs(bf16[0] - f32) <= 2e-2 * f32
    assert bf16[-1] < 0.5 * bf16[0], bf16[::10]
