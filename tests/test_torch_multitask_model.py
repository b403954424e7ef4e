"""The port's MultiTaskUNet2D against the JAX package's, on the same weights
carried through the checkpoint format and the same seeded numpy inputs:
two tasks with different sample dims and class counts, the eval forward,
the bf16 build, the train-mode forward with the shared encoder's running
statistics updated once per task, one float32 Adam multi-task step, the
eval step's per-task counts, the Validation callback's logs, weight files
in both directions, and the build from a project's build group."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiplanarunet_tpu.callbacks.validation import (
    Validation as JValidation,
)
from multiplanarunet_tpu.evaluate.losses import (
    SparseCategoricalCrossentropy as JSCE,
)
from multiplanarunet_tpu.evaluate.metrics import METRICS as JMETRICS
from multiplanarunet_tpu.logging import ScreenLogger as JScreen
from multiplanarunet_tpu.models import checkpoint as jckpt
from multiplanarunet_tpu.models.multitask_unet import (
    MultiTaskUNet2D as JMultiTask,
)
from multiplanarunet_tpu.train import Trainer as JTrainer
from multiplanarunet_tpu.train import train_step as jts
from multiplanarunet_tpu.train.utils import init_optimizer as j_init_opt
from multiplanarunet_tpu_torch.callbacks.validation import Validation
from multiplanarunet_tpu_torch.evaluate.losses import (
    SparseCategoricalCrossentropy,
)
from multiplanarunet_tpu_torch.evaluate.metrics import METRICS
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.models import checkpoint as tckpt
from multiplanarunet_tpu_torch.models.model_init import (
    build_model,
    load_unet_weights,
    model_initializer,
)
from multiplanarunet_tpu_torch.models.multitask_unet import MultiTaskUNet2D
from multiplanarunet_tpu_torch.train.train_step import (
    MultiTaskEvalStep,
    MultiTaskTrainStep,
)
from multiplanarunet_tpu_torch.train.trainer import Trainer
from multiplanarunet_tpu_torch.train.utils import init_optimizer
from tests.torch_projects import torch_threads  # noqa: F401


# Two tasks: 16 px with 3 classes, 30 px (both decoder levels crop) with 4
KW = dict(task_names=("a", "b"), n_classes=(3, 4), n_channels=(2, 2),
          depth=2, init_filters=8)
DIMS = (16, 30)
# The steps' batches: a loss needs labels of the output's size, which an
# input side divisible by 2^depth keeps
STEP_DIMS = (16, 24)
LR = 1e-3
ACC = "sparse_categorical_accuracy"


def _variables(jmodel, seed=0):
    """flax variables of jmodel's own tree (traced by eval_shape, no
    compile): glorot-uniform kernels, random biases, BN parameters and
    running statistics, so every leaf's mapping is exercised."""
    xs = tuple(jnp.zeros((1, d, d, 2)) for d in DIMS)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), xs,
                                                train=False))
    rng = np.random.RandomState(seed)

    def param(s):
        if len(s.shape) > 1:  # a kernel (kh, kw, I, O)
            lim = np.sqrt(6.0 / (np.prod(s.shape[:-1]) + s.shape[-1]))
            return rng.uniform(-lim, lim, s.shape).astype(np.float32)
        return (0.05 * rng.randn(*s.shape)).astype(np.float32)

    def plus_one(tree, leaf):
        return {k: (plus_one(v, leaf) if isinstance(v, dict)
                    else v + 1.0 if k == leaf else v)
                for k, v in tree.items()}

    params = plus_one(jax.tree.map(param, shapes["params"]), "scale")
    stats = plus_one(jax.tree.map(
        lambda s: (0.2 * rng.rand(*s.shape)).astype(np.float32),
        shapes["batch_stats"]), "var")
    return params, stats


def _port(params, stats, **kw):
    model = MultiTaskUNet2D(**{**KW, **kw})
    model.load_state_dict(tckpt.unet_state_dict_from_jax(params, stats,
                                                         model))
    return model


def _batches(seed, n=3, dims=DIMS):
    """Per task a channels-last (x, y, w) batch of n."""
    rng = np.random.RandomState(seed)
    out = []
    for d, nc in zip(dims, KW["n_classes"]):
        out.append((rng.randn(n, d, d, 2).astype(np.float32),
                    rng.randint(0, nc, (n, d, d, 1)).astype(np.int32),
                    (rng.rand(n) + 0.3).astype(np.float32)))
    return [list(part) for part in zip(*out)]


def _nchw(xs):
    return [torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs]


def _flat(tree):
    """{'a/b/leaf': array} of a nested dict of arrays."""
    return {"/".join(str(p.key) for p in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jmodel():
    return JMultiTask(dim=DIMS, **KW)


@pytest.fixture(scope="module")
def japply(jmodel):
    """The JAX model's eval forward, compiled once."""
    fn = jax.jit(lambda v, xs: jmodel.apply(v, xs, train=False))
    return lambda params, stats, xs: fn(
        {"params": params, "batch_stats": stats}, tuple(map(jnp.asarray, xs)))


def test_eval_forward_matches_flax(jmodel, japply):
    """Per-task probabilities within 1e-5; one encoder, a head per task,
    named as flax names them."""
    params, stats = _variables(jmodel, seed=1)
    model = _port(params, stats).eval()
    assert {k.split(".")[0] for k in model.state_dict()} == {
        "encoder", "task_a", "task_b"}
    xs, _, _ = _batches(2)
    want = japply(params, stats, xs)
    with torch.no_grad():
        got = model(_nchw(xs))
    for g, w, nc in zip(got, want, KW["n_classes"]):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape and g.shape[-1] == nc
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)


def test_named_errors(jmodel):
    """A wrong number of task inputs and differing n_channels raise
    ValueError, as they do in the JAX model."""
    model = MultiTaskUNet2D(**KW)
    with pytest.raises(ValueError, match="Expected 2 task inputs"):
        model([torch.zeros(1, 2, 16, 16)])
    with pytest.raises(ValueError, match="Expected 2 task inputs"):
        jmodel.init(jax.random.PRNGKey(0), (jnp.zeros((1, 16, 16, 2)),))
    with pytest.raises(ValueError, match="same n_channels"):
        MultiTaskUNet2D(**{**KW, "n_channels": (1, 2)})
    with pytest.raises(ValueError, match="same n_channels"):
        JMultiTask(dim=DIMS, **{**KW, "n_channels": (1, 2)}).init(
            jax.random.PRNGKey(0), (jnp.zeros((1, 16, 16, 1)),
                                    jnp.zeros((1, 30, 30, 2))))


def test_bf16_build_close_to_f32(jmodel):
    """build_model under mixed precision: bf16 convolutions with float32
    parameters, statistics and out conv; float32 outputs within 0.05 of
    the float32 model's and the argmax mostly agreeing."""
    params, stats = _variables(jmodel, seed=3)
    build = dict(model_class_name="MultiTaskUNet2D", dim=list(DIMS),
                 **{k: list(v) if isinstance(v, tuple) else v
                    for k, v in KW.items()})
    f32 = _port(params, stats).eval()
    bf16 = build_model(build, mixed_precision=True)
    assert bf16.dtype == torch.bfloat16 and not bf16.training
    bf16.load_state_dict(f32.state_dict())
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    xs, _, _ = _batches(4)
    with torch.no_grad():
        for a, b in zip(f32(_nchw(xs)), bf16(_nchw(xs))):
            assert b.dtype == torch.float32
            assert (a - b).abs().max() < 0.05
            assert (a.argmax(1) == b.argmax(1)).float().mean() > 0.95


def test_train_mode_forward_and_chained_encoder_stats(jmodel):
    """Every new running statistic within 1e-5 of flax's: the shared
    encoder's statistics are updated once per task, in task order (r <-
    0.99 (0.99 r + 0.01 m_a) + 0.01 m_b), each head's once. Train-mode
    probabilities within 3e-5: both frameworks normalise with float32
    batch statistics, E[x^2] - E[x]^2 reduced in their own order, and at
    the 30 px task's shapes the two differ by up to 2.5e-5 (the largest
    of 28 seeded draws of weights and inputs, with flax's apply compiled
    or not), as UNet3D's train-mode forward does
    (tests/test_torch_3d_model.py)."""
    params, stats = _variables(jmodel, seed=5)
    model = _port(params, stats).train()
    xs, _, _ = _batches(6)
    out, mutated = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, tuple(map(jnp.asarray, xs)))
    with torch.no_grad():
        got = model(_nchw(xs))
    for g, w in zip(got, out):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), atol=3e-5)
    want = _flat(mutated["batch_stats"])
    got_stats = _flat(tckpt.unet_variables_from_model(model)[1])
    assert set(got_stats) == set(want)
    for k in want:
        np.testing.assert_allclose(got_stats[k], want[k], atol=1e-5,
                                   err_msg=k)
    # The chain: one task's input alone moves the encoder elsewhere
    single = _port(params, stats).train()
    with torch.no_grad():
        single.encoder(_nchw(xs)[0])
    one = _flat(tckpt.unet_variables_from_model(single)[1])
    key = "encoder/encoder_L0/bn/mean"
    assert np.abs(one[key] - want[key]).max() > 1e-3


def test_one_adam_step_matches_make_multitask_train_step(jmodel):
    """One float32 Adam step: the loss and each task's loss within 1e-6
    relative, each task's metric within 1e-6, the running statistics
    within 1e-5; parameters as in the single-task step's test (Adam's
    first step is -lr g / (|g| + eps): every parameter within 2 lr of the
    JAX one, at least 99.9% within 1e-3 lr)."""
    params, stats = _variables(jmodel, seed=7)
    xs, ys, ws = _batches(8, n=4, dims=STEP_DIMS)
    tx = j_init_opt("Adam", lr=LR)
    state = jts.create_train_state({"params": params, "batch_stats": stats},
                                   tx)
    step = jts.make_multitask_train_step(
        jmodel, tx, JSCE(), {ACC: JMETRICS[ACC]}, donate=False)
    new_state, jlogs = step(state, *(tuple(map(jnp.asarray, part))
                                     for part in (xs, ys, ws)))

    model = _port(params, stats)
    opt = init_optimizer("Adam", model.parameters(), lr=LR)
    tstep = MultiTaskTrainStep(model, opt, SparseCategoricalCrossentropy(),
                               {ACC: METRICS[ACC]})
    logs = tstep([torch.from_numpy(x) for x in xs],
                 [torch.from_numpy(y) for y in ys], ws)
    assert set(logs) == set(jlogs) == {
        "loss", "task_0/loss", "task_1/loss", f"task_0/{ACC}",
        f"task_1/{ACC}"}
    for k in ("loss", "task_0/loss", "task_1/loss"):
        np.testing.assert_allclose(logs[k].item(), float(jlogs[k]),
                                   rtol=1e-6, err_msg=k)
    for k in (f"task_0/{ACC}", f"task_1/{ACC}"):
        np.testing.assert_allclose(logs[k].item(), float(jlogs[k]),
                                   atol=1e-6, err_msg=k)
    new_params, new_stats = tckpt.unet_variables_from_model(model)
    want_s = _flat(new_state.batch_stats)
    for k, v in _flat(new_stats).items():
        np.testing.assert_allclose(v, want_s[k], atol=1e-5, err_msg=k)
    want_p, got_p, start = (_flat(new_state.params), _flat(new_params),
                            _flat(params))
    assert set(got_p) == set(want_p)
    diffs = np.concatenate([np.abs(got_p[k] - want_p[k]).ravel()
                            for k in want_p])
    moved = np.concatenate([np.abs(want_p[k] - start[k]).ravel()
                            for k in want_p])
    assert moved.max() <= LR * 1.0001 and np.median(moved) > 0.5 * LR
    assert diffs.max() <= 2 * LR
    assert (diffs <= 1e-3 * LR).mean() >= 0.999, (diffs <= 1e-3 * LR).mean()


def test_eval_step_counts_equal_jax(jmodel):
    params, stats = _variables(jmodel, seed=9)
    xs, ys, ws = _batches(10, n=4, dims=STEP_DIMS)
    metric = {"sparse_fg_recall": JMETRICS["sparse_fg_recall"]}
    jlogs, jcounts = jts.make_multitask_eval_step(
        jmodel, JSCE(), metric, KW["n_classes"])(
        params, stats, *(tuple(map(jnp.asarray, p)) for p in (xs, ys, ws)))
    model = _port(params, stats)
    ev = MultiTaskEvalStep(model, SparseCategoricalCrossentropy(),
                           {"sparse_fg_recall": METRICS["sparse_fg_recall"]},
                           KW["n_classes"])
    logs, counts = ev([torch.from_numpy(x) for x in xs],
                      [torch.from_numpy(y) for y in ys], ws)
    assert not model.training and len(counts) == 2
    for task, jtask, nc in zip(counts, jcounts, KW["n_classes"]):
        for a, b in zip(task, jtask):
            assert a.dtype == torch.int32 and a.shape == (nc,)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert set(logs) == set(jlogs)
    for k in logs:
        np.testing.assert_allclose(logs[k].item(), float(jlogs[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


class _Replay:
    """A validation sequence replaying fixed per-task batches."""

    def __init__(self, batches, to_tensor):
        self.batches = batches
        self.to_tensor = to_tensor
        self.batch_size = 4

    def __getitem__(self, i):
        xs, ys, ws = self.batches[i % len(self.batches)]
        return ([self.to_tensor(x) for x in xs],
                [self.to_tensor(y) for y in ys], ws)


def test_validation_logs_match_jax(jmodel):
    """Validation over 2 batches from the same weights: the same keys;
    the logs computed from the counts (val_task_{t}/dice, and the task
    means val_dice, val_precision, val_recall) equal to JAX's; the mean
    losses and metrics within 1e-6."""
    params, stats = _variables(jmodel, seed=11)
    batches = [_batches(12 + i, n=4, dims=STEP_DIMS) for i in range(2)]
    jtrainer = JTrainer(jmodel, {"params": params, "batch_stats": stats},
                        logger=JScreen(False)).compile_model(
        "Adam", {"lr": LR}, "SparseCategoricalCrossentropy", [ACC])
    want = {}
    jcb = JValidation(_Replay(batches, jnp.asarray), 2, verbose=False)
    jcb.set_trainer(jtrainer)
    jcb.on_epoch_end(0, want)

    trainer = Trainer(_port(params, stats), logger=ScreenLogger(False),
                      device="cpu").compile_model(
        "Adam", {"lr": LR}, "SparseCategoricalCrossentropy", [ACC])
    assert trainer.multitask and trainer.n_classes == [3, 4]
    got = {}
    cb = Validation(_Replay(batches, torch.from_numpy), 2, verbose=True,
                    logger=ScreenLogger(False))
    cb.set_trainer(trainer)
    cb.on_epoch_end(0, got)
    assert set(got) == set(want)
    assert {"val_task_0/dice", "val_task_1/dice", "val_dice",
            f"val_task_1/{ACC}", "val_task_0/loss"} <= set(got)
    for k in want:
        if "loss" in k or ACC in k:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
        else:
            assert got[k] == want[k], k
    np.testing.assert_allclose(
        got["val_dice"], (got["val_task_0/dice"] + got["val_task_1/dice"]) / 2,
        rtol=1e-12)


def test_weight_files_cross_both_ways(jmodel, japply, tmp_path):
    """A port-trained multi-task model's .npz loads in the JAX model and
    gives the port's probabilities within 1e-5; a JAX-written one loads
    in the port bit-exactly."""
    params, stats = _variables(jmodel, seed=13)
    model = _port(params, stats).train()
    xs, ys, ws = _batches(14, dims=STEP_DIMS)
    opt = init_optimizer("Adam", model.parameters(), lr=LR)
    MultiTaskTrainStep(model, opt, SparseCategoricalCrossentropy(), {})(
        [torch.from_numpy(x) for x in xs],
        [torch.from_numpy(y) for y in ys], ws)
    model.eval()
    path = tmp_path / "port.npz"
    tckpt.save_unet_weights(path, model, meta={"epoch": 1})
    jparams, jstats, meta = jckpt.load_weights(path)
    assert meta == {"epoch": 1}
    assert set(jparams) == {"encoder", "task_a", "task_b"}
    xs, _, _ = _batches(15)
    want = japply(jparams, jstats, xs)
    with torch.no_grad():
        got = model(_nchw(xs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), atol=1e-5)
    jpath = tmp_path / "jax.npz"
    jckpt.save_weights(jpath, params, stats)
    loaded = load_unet_weights(MultiTaskUNet2D(**KW), jpath)
    want_state = _port(params, stats).state_dict()
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, want_state[k]), k


def test_build_model_and_initializer(jmodel, tmp_path):
    """build_model takes the lists of the main build group (as
    prepare_for_multi_task_2d writes them; unknown keys ignored);
    model_initializer initialises glorot from seed 0 and restores a
    JAX-written checkpoint by name, and from a project's last @epoch file
    on continue_training."""
    build = dict(model_class_name="MultiTaskUNet2D", task_names=["a", "b"],
                 n_classes=[3, 4], n_channels=[2, 2], dim=list(DIMS),
                 depth=2, init_filters=8, complexity_factor=1,
                 l1_reg=False, l2_reg=False)
    hp = {"build": build, "fit": {"mixed_precision": False}}
    fresh, epoch, lr = model_initializer(hp, device="cpu")
    assert type(fresh) is MultiTaskUNet2D and fresh.training
    assert epoch == 0 and lr is None and fresh.dim == list(DIMS)
    conv = fresh.task_b.decoder_L0_conv_up
    lim = np.sqrt(6.0 / (4 * (conv.in_channels + conv.out_channels)))
    assert conv.weight.abs().max() <= lim and not conv.bias.any()
    again, _, _ = model_initializer(hp, device="cpu")
    assert all(torch.equal(v, again.state_dict()[k])
               for k, v in fresh.state_dict().items())
    params, stats = _variables(jmodel, seed=15)
    path = tmp_path / "w.npz"
    jckpt.save_weights(path, params, stats)
    restored, _, _ = model_initializer(hp, initialize_from=path,
                                       device="cpu")
    want = _port(params, stats).state_dict()
    for k, v in restored.state_dict().items():
        assert torch.equal(v, want[k]), k
    (tmp_path / "model").mkdir()
    (tmp_path / "logs").mkdir()
    jckpt.save_weights(tmp_path / "model" / "@epoch_02_val_dice_0.5.npz",
                       params, stats)
    (tmp_path / "logs" / "training.csv").write_text(
        "epoch,loss,lr\n0,1.0,0.001\n1,0.9,0.0005\n2,0.8,0.0001\n")
    cont, epoch, lr = model_initializer(hp, continue_training=True,
                                        project_dir=tmp_path, device="cpu")
    assert epoch == 2 and lr == pytest.approx(0.0005)
    for k, v in cont.state_dict().items():
        assert torch.equal(v, want[k]), k
