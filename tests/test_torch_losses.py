"""The port's losses and in-step metrics against the JAX package's, on the
same seeded numpy inputs: every loss with and without sample weights
(value within 1e-6, gradient with respect to y_pred within 1e-5 of
jax.grad), the metrics (within 1e-6) and the epoch statistics."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiplanarunet_tpu.evaluate import losses as jlosses
from multiplanarunet_tpu.evaluate import metrics as jmetrics
from multiplanarunet_tpu_torch.evaluate import losses as tlosses
from multiplanarunet_tpu_torch.evaluate import metrics as tmetrics
from tests.torch_projects import torch_threads  # noqa: F401


LOSS_CASES = [
    ("SparseCategoricalCrossentropy", {}),
    ("SparseDiceLoss", {}),
    ("SparseJaccardDistanceLoss", {"smooth": 0.5}),
    ("SparseExponentialLogarithmicLoss", {}),
    ("SparseExpLogDice", {"gamma_dice": 0.4, "weight_cross": 0.5}),
    ("SparseFocalLoss", {"gamma": 1.5, "class_weights": [0.5, 1.0, 2.0,
                                                         1.5]}),
    ("SparseGeneralizedDiceLoss", {}),
    ("SparseGeneralizedDiceLoss", {"type_weight": "Simple"}),
    ("SparseGeneralizedDiceLoss", {"type_weight": "Uniform"}),
]


def _inputs(seed, n_classes=4, shape=(3, 9, 8), absent=None):
    rng = np.random.RandomState(seed)
    logits = rng.randn(*shape, n_classes).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    y = rng.randint(0, n_classes, shape + (1,)).astype(np.int32)
    if absent is not None:  # a class missing from the targets
        y[y == absent] = 0
    w = rng.rand(shape[0]).astype(np.float32) + 0.2
    return probs.astype(np.float32), y, w


@pytest.mark.parametrize("name,kwargs", LOSS_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(LOSS_CASES)])
@pytest.mark.parametrize("weighted", [False, True])
def test_loss_value_and_grad_match_jax(name, kwargs, weighted):
    probs, y, w = _inputs(0, absent=2)
    jloss = jlosses.LOSSES[name](**kwargs)
    tloss = tlosses.LOSSES[name](**kwargs)
    sw = w if weighted else None

    def jfn(p):
        return jloss(jnp.asarray(y), p, sample_weight=sw)

    want, want_grad = jax.value_and_grad(jfn)(jnp.asarray(probs))
    p = torch.from_numpy(probs).requires_grad_()
    got = tloss(torch.from_numpy(y), p, sample_weight=sw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-5)
    # per-element values without reduction
    jl = jlosses.LOSSES[name](reduction="none", **kwargs)
    tl = tlosses.LOSSES[name](reduction="none", **kwargs)
    np.testing.assert_allclose(
        tl(torch.from_numpy(y), torch.from_numpy(probs)).numpy(),
        np.asarray(jl(jnp.asarray(y), jnp.asarray(probs))), rtol=1e-6,
        atol=1e-6)


# Losses of the port's own, with no JAX counterpart (held against plain
# formulas in tests/test_torch_swin_unetr.py)
PORT_ONLY = {"SparseDiceCELoss"}


def test_loss_table_and_squeezed_targets():
    assert sorted(set(tlosses.LOSSES) - PORT_ONLY) == sorted(jlosses.LOSSES)
    assert tlosses.SparseExpLogDice is tlosses.SparseExponentialLogarithmicLoss
    probs, y, _ = _inputs(1)
    a = tlosses.SparseDiceLoss()(torch.from_numpy(y),
                                 torch.from_numpy(probs))
    b = tlosses.SparseDiceLoss()(torch.from_numpy(y[..., 0]),
                                 torch.from_numpy(probs))
    assert a.item() == b.item()
    with pytest.raises(ValueError, match="type_weight"):
        tlosses.sparse_generalized_dice_loss(
            torch.from_numpy(y), torch.from_numpy(probs), type_weight="x")


@pytest.mark.parametrize("name", sorted(jmetrics.METRICS))
def test_in_step_metrics_match_jax(name):
    if name == "one_class_dice":
        rng = np.random.RandomState(3)
        probs = rng.rand(3, 9, 8, 1).astype(np.float32)
        y = rng.randint(0, 2, (3, 9, 8, 1)).astype(np.float32)
    else:
        probs, y, _ = _inputs(2, n_classes=5)
    want = float(jmetrics.METRICS[name](jnp.asarray(y), jnp.asarray(probs)))
    got = tmetrics.METRICS[name](torch.from_numpy(y),
                                 torch.from_numpy(probs)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_confusion_matrix_and_epoch_statistics():
    rng = np.random.RandomState(4)
    y = rng.randint(0, 4, 500)
    p = rng.randint(0, 4, 500)
    want = np.asarray(jmetrics.confusion_matrix(jnp.asarray(y),
                                                jnp.asarray(p), 4))
    got = tmetrics.confusion_matrix(torch.from_numpy(y), torch.from_numpy(p),
                                    4).numpy()
    np.testing.assert_array_equal(got, want)
    tp, rel, sel = rng.randint(0, 50, (3, 5)).astype(np.float64)
    rel[2] = 0
    for ignore_bg in (True, False):
        a = tmetrics.precision_recall_dice(tp, rel, sel, ignore_bg)
        b = jmetrics.precision_recall_dice(tp, rel, sel, ignore_bg)
        for x, z in zip(a[0] + a[1], b[0] + b[1]):
            np.testing.assert_array_equal(x, z)
