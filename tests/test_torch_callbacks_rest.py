"""The port's callbacks beyond the default set, Trainer.predict_batch,
the plotting module and views.png, each against its JAX twin on the
same numpy inputs (after `tests/test_callbacks_misc.py`'s stub
trainers), then both packages' `mp train` + `mp predict` on a tiny
project that configures every YAML-configurable callback and the
QuantileTransformer scaler."""
import json
import sys

import numpy as np
import pytest
import torch

import jax

from multiplanarunet_tpu.bin import predict as j_predict
from multiplanarunet_tpu.callbacks import callbacks as j_cb
from multiplanarunet_tpu.callbacks import funcs as j_funcs
from multiplanarunet_tpu.callbacks.validation import (
    ValDiceScores as JValDiceScores,
)
from multiplanarunet_tpu.models import checkpoint as jckpt
from multiplanarunet_tpu.models.unet import UNet as JUNet
from multiplanarunet_tpu.preprocessing import (
    data_preparation_funcs as j_prep,
)
from multiplanarunet_tpu.train.trainer import Trainer as JTrainer
from multiplanarunet_tpu_torch.bin import mp as t_mp
from multiplanarunet_tpu_torch.callbacks import callbacks as t_cb
from multiplanarunet_tpu_torch.callbacks.funcs import (
    CALLBACKS,
    CallbackNotPortedError,
    init_callback_objects,
)
from multiplanarunet_tpu_torch.callbacks.validation import ValDiceScores
from multiplanarunet_tpu_torch.io import nifti
from multiplanarunet_tpu_torch.models import checkpoint as tckpt
from multiplanarunet_tpu_torch.models.unet import UNet
from multiplanarunet_tpu_torch.preprocessing import (
    data_preparation_funcs as t_prep,
)
from multiplanarunet_tpu_torch.sequences import RandomDataFeeder
from multiplanarunet_tpu_torch.train.trainer import Trainer
from tests.torch_projects import (  # noqa: F401
    flax_init,
    run_entry,
    run_jax_entry,
    torch_threads,
    train_args,
    trained_pair,
)


N_CLASSES = 3


class _Rec:
    """A logger that keeps its lines and warnings."""

    def __init__(self):
        self.lines, self.warnings = [], []

    def __call__(self, *args, **kwargs):
        self.lines.append(" ".join(str(a) for a in args))

    def warn(self, *args, **kwargs):
        self.warnings.append(" ".join(str(a) for a in args))


class _StubSeq:
    fg_batch_fraction = 0.5

    def __getitem__(self, i):
        rng = np.random.RandomState(0)
        X = rng.rand(2, 16, 16, 1).astype(np.float32)
        y = rng.randint(0, N_CLASSES, (2, 16, 16, 1))
        return X, y, np.ones(2, np.float32)


def _stub_probs(B):
    logits = np.random.RandomState(1).rand(B, 16, 16, N_CLASSES)
    return (logits / logits.sum(-1, keepdims=True)).astype(np.float32)


class _PortStub:
    """The port's Trainer surface the callbacks use."""

    def __init__(self, model=None):
        self.logger = _Rec()
        self.stop_training = False
        self.train_sequence = _StubSeq()
        self.val_sequence = None
        self.device = torch.device("cpu")
        self.model = model

    def predict_batch(self, X):
        return torch.from_numpy(_stub_probs(len(X)))


class _JaxStub:
    def __init__(self, params=None):
        self.logger = _Rec()
        self.stop_training = False
        self.train_sequence = _StubSeq()
        self.val_sequence = None
        self.state = type("S", (), {"params": params})

    def predict_batch(self, X):
        return jax.numpy.asarray(_stub_probs(len(X)))


def _both(name, **kwargs):
    """(port callback, JAX callback) of one class, each on its stub."""
    t, j = getattr(t_cb, name)(**kwargs), getattr(j_cb, name)(**kwargs)
    t.set_trainer(_PortStub())
    j.set_trainer(_JaxStub())
    return t, j


@pytest.fixture
def no_matplotlib(monkeypatch):
    """matplotlib made unimportable, as on a machine without it."""
    for mod in list(sys.modules):
        if mod.split(".")[0] in ("matplotlib", "mpl_toolkits"):
            monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "mpl_toolkits", None)


# ----------------------------------------------------------- the registry
def test_registry_holds_the_sixteen_jax_classes():
    assert len(CALLBACKS) == 16
    for name, cls in CALLBACKS.items():
        assert j_funcs._resolve(name).__name__ == cls.__name__ == name
    with pytest.raises(CallbackNotPortedError, match="NoSuchCallback"):
        init_callback_objects([{"class_name": "NoSuchCallback"}])
    with pytest.raises(ValueError):
        j_funcs._resolve("NoSuchCallback")
    objs, by_name = init_callback_objects(
        [{"class_name": "DividerLine", "nickname": "div"},
         {"class_name": "Profiler", "kwargs": {"epochs": [1]},
          "start_from": 1}])
    assert isinstance(by_name["div"], t_cb.DividerLine)
    assert isinstance(objs[1], t_cb.DelayedCallback)


# -------------------------------------------------------- log callbacks
def test_memory_divider_and_mean_reduce_match_jax():
    t, j = _both("MemoryConsumption", max_gib=1e-9)
    t_logs, j_logs = {}, {}
    t.on_epoch_end(0, t_logs)
    j.on_epoch_end(0, j_logs)
    assert t_logs["memory_gib"] > 0 and j_logs["memory_gib"] > 0
    assert t.trainer.stop_training and j.trainer.stop_training
    assert [l.split("~")[0] for l in t.trainer.logger.lines] == \
        [l.split("~")[0] for l in j.trainer.logger.lines]

    t, j = _both("DividerLine")
    t.on_epoch_end(3, {})
    j.on_epoch_end(3, {})
    assert t.trainer.logger.lines == j.trainer.logger.lines == ["-" * 60]

    t, j = _both("MeanReduceLogArrays")
    t_logs = {"a": np.array([1.0, 4.0]), "b": 2.0, "c": [3.0, 5.0]}
    j_logs = dict(t_logs)
    t.on_epoch_end(0, t_logs)
    j.on_epoch_end(0, j_logs)
    assert t_logs == j_logs == {"a": 2.5, "b": 2.0, "c": 4.0}


@pytest.mark.parametrize("recall", [0.8, 1.3, -0.2, None])
def test_fg_batch_balancer_matches_jax(recall):
    t, j = _both("FGBatchBalancer")
    logs = {} if recall is None else {"val_recall": recall}
    t.on_epoch_end(0, dict(logs))
    j.on_epoch_end(0, dict(logs))
    assert t.trainer.train_sequence.fg_batch_fraction == \
        j.trainer.train_sequence.fg_batch_fraction
    assert t.trainer.logger.lines == j.trainer.logger.lines


def _flax_unet(seed=0):
    model = JUNet(n_classes=N_CLASSES, n_channels=1, depth=2,
                  init_filters=8, complexity_factor=1.0)
    v = flax_init(model, jax.random.PRNGKey(seed), (1, 16, 16, 1))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rng.randn(
        *p.shape).astype(np.float32), v["params"])
    stats = jax.tree.map(lambda s: np.asarray(s) + 0.1 * rng.rand(
        *s.shape).astype(np.float32), v["batch_stats"])
    return model, params, stats


def _port_unet(params, stats, tmp_path):
    jckpt.save_weights(tmp_path / "w.npz", params, stats)
    p, s, _ = tckpt.load_weights(tmp_path / "w.npz")
    model = UNet(n_classes=N_CLASSES, n_channels=1, depth=2, init_filters=8)
    model.load_state_dict(tckpt.unet_state_dict_from_jax(p, s, model))
    return model


@pytest.mark.parametrize("layer", [None, "encoder_L0", "out_conv"])
def test_print_layer_weights_matches_jax(tmp_path, layer):
    """Statistics over the params only (the running statistics of the
    BatchNorms are not mixed in), from weights carried across."""
    _, params, stats = _flax_unet()
    model = _port_unet(params, stats, tmp_path)
    t = t_cb.PrintLayerWeights(layer=layer)
    t.set_trainer(_PortStub(model))
    j = j_cb.PrintLayerWeights(layer=layer)
    j.set_trainer(_JaxStub(params))
    t.on_epoch_end(0, {})
    j.on_epoch_end(0, {})
    assert t.trainer.logger.lines == j.trainer.logger.lines
    # the arrays behind the line, element for element
    t_params = tckpt.unet_variables_from_model(model)[0]
    j_params = params
    if layer:
        t_params, j_params = t_params[layer], j_params[layer]
    t_flat = np.concatenate([a.ravel() for a in
                             t_cb._sorted_leaves(t_params)])
    j_flat = np.concatenate([np.asarray(a).ravel() for a in
                             jax.tree_util.tree_leaves(j_params)])
    np.testing.assert_array_equal(t_flat, j_flat)
    for stat in (np.mean, np.std, np.min, np.max):
        np.testing.assert_allclose(stat(t_flat), stat(j_flat), rtol=1e-6)
    # every 2nd epoch only
    t2 = t_cb.PrintLayerWeights(every=2)
    t2.set_trainer(_PortStub(model))
    t2.on_epoch_end(1, {})
    assert t2.trainer.logger.lines == []


# ------------------------------------------------------------- plotting
def test_plotting_callbacks_write_pngs(tmp_path):
    for root, trainer in ((tmp_path / "t", _PortStub()),
                          (tmp_path / "j", _JaxStub())):
        mod = t_cb if isinstance(trainer, _PortStub) else j_cb
        csv = root / "training.csv"
        root.mkdir()
        csv.write_text("epoch,loss,val_dice\n0,1.0,0.2\n1,0.5,0.4\n")
        cbs = [mod.SavePredictionImages(out_dir=root / "imgs"),
               mod.SaveOutputAs2DImage(out_dir=root / "outs"),
               mod.LearningCurve(log_dir=root, out_dir=root)]
        for cb in cbs:
            cb.set_trainer(trainer)
            cb.on_epoch_end(1, {})
        assert trainer.logger.warnings == []
    for rel in ("imgs/epoch_001.png", "outs/output_epoch_001.png",
                "curve.png"):
        assert (tmp_path / "t" / rel).stat().st_size > 0, rel
        assert (tmp_path / "j" / rel).exists(), rel


def test_plotting_callbacks_warn_without_matplotlib(tmp_path, no_matplotlib):
    """A missing matplotlib logs one warning per callback and training
    goes on; the batch is not drawn (as in the JAX package, whose
    plotting import fails first)."""
    trainer = _PortStub()
    drawn = []
    trainer.val_sequence = type("Seq", (), {
        "__getitem__": lambda self, i: drawn.append(i)})()
    (tmp_path / "training.csv").write_text("epoch,loss\n0,1.0\n")
    cbs = [t_cb.SavePredictionImages(out_dir=tmp_path / "imgs"),
           t_cb.SaveOutputAs2DImage(out_dir=tmp_path / "outs"),
           t_cb.LearningCurve(log_dir=tmp_path, out_dir=tmp_path)]
    for cb in cbs:
        cb.set_trainer(trainer)
        cb.on_epoch_end(0, {})
    assert len(trainer.logger.warnings) == 3
    for warning, name in zip(trainer.logger.warnings,
                             ("SavePredictionImages", "SaveOutputAs2DImage",
                              "LearningCurve")):
        assert warning.startswith(f"{name} failed")
        assert "matplotlib" in warning
    assert drawn == []
    assert not any(tmp_path.rglob("*.png"))


def test_views_png_and_views_match_jax(tmp_path, no_matplotlib):
    """load_or_create_views draws the same views as the JAX package from
    the same seed; without matplotlib it warns and writes no png."""
    out = {}
    for name, mod in (("t", t_prep), ("j", j_prep)):
        base = tmp_path / name
        base.mkdir()
        hparams = {"fit": {"views": 4, "noise_sd": 0.1,
                           "intrp_style": "iso_live"}}
        logger = _Rec()
        np.random.seed(4)
        views = mod.load_or_create_views(hparams, False, logger, str(base))
        out[name] = np.load(base / "views.npz")["arr_0"]
        assert not (base / "views.png").exists()
        assert any("Could not plot views" in w for w in logger.warnings)
        if name == "t":
            np.testing.assert_array_equal(views, out["t"])
    np.testing.assert_array_equal(out["t"], out["j"])


def test_views_png_drawn(tmp_path):
    logger = _Rec()
    hparams = {"fit": {"views": 3, "noise_sd": 0.1}}
    t_prep.load_or_create_views(hparams, False, logger, str(tmp_path))
    assert logger.warnings == []
    assert (tmp_path / "views.png").stat().st_size > 0


# ------------------------------------------------------------- profiler
def test_profiler_writes_a_chrome_trace(tmp_path):
    cb = t_cb.Profiler(log_dir=tmp_path / "prof", epochs=(1,))
    cb.set_trainer(_PortStub())
    cb.on_epoch_begin(0, {})
    assert cb._prof is None  # epoch 0 is not traced
    cb.on_epoch_begin(1, {})
    torch.ones(64, 64) @ torch.ones(64, 64)
    cb.on_epoch_end(1, {})
    trace = tmp_path / "prof" / "trace_epoch_1.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("trace written" in l for l in cb.trainer.logger.lines)
    # on_train_end closes a trace left open
    cb2 = t_cb.Profiler(log_dir=tmp_path / "prof2", epochs=(0,))
    cb2.set_trainer(_PortStub())
    cb2.on_epoch_begin(0, {})
    cb2.on_train_end({})
    assert (tmp_path / "prof2" / "trace_epoch_0.json").exists()


# ------------------------------------------- predict_batch, ValDiceScores
@pytest.fixture(scope="module")
def twin_trainers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("twins")
    model, params, stats = _flax_unet(seed=2)
    j_trainer = JTrainer(model, {"params": params, "batch_stats": stats},
                         logger=_Rec())
    j_trainer.compile_model("Adam", {"lr": 1e-3},
                            "SparseCategoricalCrossentropy")
    t_trainer = Trainer(_port_unet(params, stats, tmp), logger=_Rec(),
                        device="cpu")
    t_trainer.compile_model("Adam", {"lr": 1e-3},
                            "SparseCategoricalCrossentropy")
    return t_trainer, j_trainer


def test_predict_batch_matches_jax(twin_trainers):
    t_trainer, j_trainer = twin_trainers
    X = np.random.RandomState(5).rand(3, 16, 16, 1).astype(np.float32)
    t_trainer.model.train()
    got = t_trainer.predict_batch(X)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == torch.float32 and not got.requires_grad
    assert not t_trainer.model.training  # eval mode: running statistics
    want = np.asarray(j_trainer.predict_batch(X))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # a tensor already on the device passes through as it is
    again = t_trainer.predict_batch(torch.from_numpy(X))
    np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("batch_size", [2, 7])
def test_val_dice_scores_matches_jax(twin_trainers, batch_size):
    t_trainer, j_trainer = twin_trainers
    rng = np.random.RandomState(6)
    X = rng.rand(7, 16, 16, 1).astype(np.float32)
    y = rng.randint(0, N_CLASSES, (7, 16, 16, 1))
    # labels that follow the model in part, so the dice is not ~1/C
    pred = np.argmax(np.asarray(j_trainer.predict_batch(X)), -1)
    y[:4, ..., 0] = pred[:4]
    t = ValDiceScores((X, y), N_CLASSES, batch_size=batch_size)
    t.set_trainer(t_trainer)
    j = JValDiceScores((X, y), N_CLASSES, batch_size=batch_size)
    j.set_trainer(j_trainer)
    t_logs, j_logs = {}, {}
    t.on_epoch_end(0, t_logs)
    j.on_epoch_end(0, j_logs)
    assert abs(t_logs["val_dice"] - j_logs["val_dice"]) <= 1e-5
    assert 0.3 < t_logs["val_dice"] < 1.0
    assert t_trainer.logger.lines[-1] == j_trainer.logger.lines[-1]


def test_fit_saves_sample_images_and_runs_the_callbacks(tmp_path,
                                                        monkeypatch):
    """Trainer.fit over a RandomDataFeeder with the new callbacks
    configured by name: sample images first, then per epoch the log
    lines, memory_gib, the PNGs and the profiled epoch."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(0)
    X = rng.rand(8, 16, 16, 1).astype(np.float32)
    y = rng.randint(0, N_CLASSES, (8, 16, 16, 1))
    feeder = RandomDataFeeder(X, y, batch_size=4, device="cpu")
    model = UNet(n_classes=N_CLASSES, n_channels=1, depth=2, init_filters=4)
    trainer = Trainer(model, logger=_Rec(), device="cpu")
    trainer.compile_model("Adam", {"lr": 1e-3},
                          "SparseCategoricalCrossentropy")
    specs = [{"class_name": n} for n in (
        "MemoryConsumption", "DividerLine", "MeanReduceLogArrays",
        "SavePredictionImages", "SaveOutputAs2DImage")]
    specs += [{"class_name": "PrintLayerWeights",
               "kwargs": {"layer": "encoder_L0"}},
              {"class_name": "CSVLogger"},
              {"class_name": "LearningCurve"},
              {"class_name": "Profiler",
               "kwargs": {"log_dir": "logs/profile", "epochs": [1]}}]
    history = trainer.fit(feeder, None, batch_size=4, n_epochs=2,
                          callbacks=specs, train_im_per_epoch=8,
                          no_im=False)
    assert trainer.logger.warnings == []
    assert trainer.train_sequence is feeder
    assert all(h["memory_gib"] > 0 for h in history)
    for rel in ("images/train_images.png", "images/epoch_001.png",
                "images/outputs/output_epoch_001.png", "logs/curve.png",
                "logs/profile/trace_epoch_1.json"):
        assert (tmp_path / rel).exists(), rel
    assert sum(l == "-" * 60 for l in trainer.logger.lines) == 2
    assert sum(l.startswith("[Weights/encoder_L0] mean=")
               for l in trainer.logger.lines) == 2


def test_fit_without_matplotlib_warns_once_and_trains(tmp_path, monkeypatch,
                                                      no_matplotlib):
    monkeypatch.chdir(tmp_path)
    X = np.zeros((4, 16, 16, 1), np.float32)
    y = np.zeros((4, 16, 16, 1), np.int64)
    feeder = RandomDataFeeder(X, y, batch_size=2, device="cpu")
    trainer = Trainer(UNet(n_classes=2, depth=1, init_filters=2),
                      logger=_Rec(), device="cpu")
    trainer.compile_model("Adam", {"lr": 1e-3},
                          "SparseCategoricalCrossentropy")
    state = np.random.get_state()[1].copy()
    trainer.fit(feeder, None, batch_size=2, n_epochs=0, no_im=False)
    # no sample batch was drawn
    np.testing.assert_array_equal(np.random.get_state()[1], state)
    assert len(trainer.logger.warnings) == 1
    assert trainer.logger.warnings[0].startswith("Could not save sample")
    assert not (tmp_path / "images").exists()


def test_random_data_feeder_matches_jax():
    from multiplanarunet_tpu.sequences.simple_sequences import (
        RandomDataFeeder as JFeeder,
    )

    rng = np.random.RandomState(1)
    X = rng.rand(10, 4, 4, 1).astype(np.float32)
    y = rng.randint(0, 3, (10, 4, 4, 1))
    t = RandomDataFeeder(X, y, batch_size=3, device="cpu")
    j = JFeeder(X, y, batch_size=3)
    assert len(t) == len(j) == 4
    for _ in range(3):
        np.random.seed(9)
        tx, ty, tw = t[0]
        np.random.seed(9)
        jx, jy, jw = j[0]
        np.testing.assert_array_equal(tx.numpy(), jx)
        np.testing.assert_array_equal(ty.numpy(), jy)
        np.testing.assert_array_equal(tw, jw)


# ------------------------------------------ mp train + mp predict, both
# memory_gib is a CSV column only when MemoryConsumption runs before the
# CSVLogger writes its header (in both packages)
CONFIGURED = (
    "callbacks: [*RLOP, *MCP_CLEAN, *ES, *TIMER, "
    "{class_name: MemoryConsumption}, {class_name: DividerLine}, "
    "{class_name: LearningCurve}, {class_name: FGBatchBalancer}, "
    "{class_name: MeanReduceLogArrays}, "
    "{class_name: PrintLayerWeights, kwargs: {layer: encoder_L0}}, "
    "{class_name: SavePredictionImages}, {class_name: SaveOutputAs2DImage},"
    " {class_name: Profiler, kwargs: {log_dir: logs/profile, epochs: [1]}},"
    " *CSV]")
QUANTILE = (("dim: Null", "dim: 16\n  init_filters: 4"),
            ("depth: 4", "depth: 2"),
            ("complexity_factor: 2", "complexity_factor: 1"),
            ("views: 6", "views: 2"),
            ("batch_size: 16", "batch_size: 4"),
            ("mixed_precision: True", "mixed_precision: False"),
            ('scaler: "RobustScaler"', 'scaler: "QuantileTransformer"'),
            ("callbacks: [*RLOP, *MCP_CLEAN, *ES, *TIMER, *CSV]",
             CONFIGURED))


def test_quantile_project_with_every_callback_trains_and_predicts():
    port, jax_proj = trained_pair("MultiPlanar", QUANTILE,
                                  train_args(8, 4, images=True),
                                  (2, 1, 20, 3))
    heads = [(p / "logs" / "training.csv").read_text().splitlines()[0]
             for p in (port, jax_proj)]
    assert heads[0] == heads[1] and "memory_gib" in heads[0]
    log = (port / "logs" / "train.txt").read_text()
    for line in ("-" * 60, "[Weights/encoder_L0] mean=", "[FGBalancer]",
                 "[Profiler] trace written to"):
        assert line in log, line
    for rel in ("images/train_images.png", "images/epoch_001.png",
                "images/outputs/output_epoch_001.png", "logs/curve.png",
                "views.png", "logs/profile/trace_epoch_1.json"):
        assert (port / rel).exists(), rel
        if not rel.startswith("logs/profile"):
            assert (jax_proj / rel).exists(), rel
    run_entry(t_mp.entry_func, "predict", "--project_dir", str(port),
              "--out_dir", "pred", "--overwrite", "--device", "cpu")
    run_jax_entry(j_predict.entry_func, "--project_dir", str(jax_proj),
                  "--out_dir", "pred", "--overwrite", "--num_devices", "1")
    for proj in (port, jax_proj):
        preds = sorted((proj / "pred" / "nii_files").glob("*/PRED.nii.gz"))
        assert len(preds) == 1
        pred = nifti.load(preds[0]).get_raw_data()
        assert pred.shape == (20, 20, 20) and pred.max() < 4
