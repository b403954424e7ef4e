"""The port's Trainer loop, Validation and default callbacks on the CPU,
with a tiny UNet and replayed batches: the OOM backoff, Validation's
device-side sums against a per-batch host accumulation, the callbacks'
decisions against the JAX package's on the same log sequences, and the
one-deep prefetch."""
import numpy as np
import pytest
import torch

from multiplanarunet_tpu.callbacks import callbacks as jcb
from multiplanarunet_tpu_torch.callbacks import callbacks as tcb
from multiplanarunet_tpu_torch.callbacks.funcs import init_callback_objects
from multiplanarunet_tpu_torch.callbacks.validation import Validation
from multiplanarunet_tpu_torch.evaluate.metrics import precision_recall_dice
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.models.unet import UNet, glorot_init
from multiplanarunet_tpu_torch.sequences.base_sequence import prefetched
from multiplanarunet_tpu_torch.train.trainer import Trainer
from tests.torch_projects import torch_threads  # noqa: F401


class Replay:
    """A sequence replaying fixed batches, cut to its batch size."""

    def __init__(self, n=3, batch=4, seed=0):
        rng = np.random.RandomState(seed)
        self.batches = [
            (torch.from_numpy(rng.randn(batch, 16, 16, 1).astype(np.float32)),
             torch.from_numpy(rng.randint(0, 3, (batch, 16, 16, 1))
                              .astype(np.int32)),
             (rng.rand(batch) + 0.5).astype(np.float32)) for _ in range(n)]
        self.batch_size = batch
        self.calls = []

    def __getitem__(self, i):
        self.calls.append(i)
        X, y, w = self.batches[i % len(self.batches)]
        b = self.batch_size
        return X[:b], y[:b], w[:b]


def _trainer(lr=1e-3):
    model = glorot_init(UNet(n_classes=3, n_channels=1, depth=2,
                             init_filters=4), seed=0, device="cpu")
    return Trainer(model, logger=ScreenLogger(False),
                   device="cpu").compile_model(
        "Adam", {"lr": lr}, "SparseCategoricalCrossentropy",
        ["sparse_categorical_accuracy"])


def test_fit_logs_and_oom_backoff():
    trainer = _trainer()
    step = trainer.train_step
    sizes = []

    def flaky(X, y, w):
        sizes.append(X.shape[0])
        if X.shape[0] == 4:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return step(X, y, w)

    trainer.train_step = flaky
    train, val = Replay(), Replay(seed=1)
    history = trainer.fit(train, val, batch_size=4, n_epochs=2,
                          train_im_per_epoch=6, val_im_per_epoch=4,
                          no_im=True)
    assert sizes[0] == 4 and set(sizes[1:]) == {2}
    assert train.batch_size == val.batch_size == 2
    assert len(history) == 2 and len(sizes) == 1 + 2 * 3
    assert set(history[0]) == {"loss", "sparse_categorical_accuracy", "lr",
                               "val_loss", "val_sparse_categorical_accuracy",
                               "val_precision", "val_recall", "val_dice"}
    assert history[0]["lr"] == np.float32(1e-3)


def test_validation_matches_per_batch_host_accumulation():
    trainer = _trainer()
    seq = Replay(n=3, batch=4, seed=2)
    tp = rel = sel = 0
    logs = []
    for i in range(3):
        step_logs, counts = trainer.eval_step(*seq.batches[i])
        logs.append({k: v.item() for k, v in step_logs.items()})
        tp, rel, sel = (a + b.numpy() for a, b in zip((tp, rel, sel),
                                                       counts))
    (_, _, _), (mp, mr, md) = precision_recall_dice(tp, rel, sel)
    want = {f"val_{k}": np.mean([l[k] for l in logs]) for k in logs[0]}
    want.update(val_precision=mp, val_recall=mr, val_dice=md)
    got = {}
    cb = Validation(seq, steps=3, verbose=False)
    cb.set_trainer(trainer)
    cb.on_epoch_end(0, got)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)


class _StubTrainer:
    def __init__(self):
        self.learning_rate = 1e-3
        self.stop_training = False
        self.saved = []
        self.logger = ScreenLogger(False)

    def set_learning_rate(self, lr):
        self.learning_rate = lr

    def save_checkpoint(self, path, epoch=None):
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"w")
        self.saved.append(path.name)


@pytest.mark.parametrize("name,kwargs", [
    ("ReduceLROnPlateau", {"patience": 2, "factor": 0.5}),
    ("EarlyStopping", {"patience": 3}),
    ("ModelCheckPointClean", {"filepath": "model/@epoch_{epoch:02d}_"
                              "val_dice_{val_dice:.5f}.npz"}),
])
def test_callbacks_decide_as_jax(tmp_path, monkeypatch, name, kwargs):
    """Both packages' callbacks over the same val_dice sequence: the same
    learning rates, stop epoch, and checkpoint files left on disk."""
    dice = [0.1, 0.3, 0.3, 0.25, 0.31, 0.31, 0.2, 0.2, 0.2]
    out = {}
    for pkg, mod in (("jax", jcb), ("port", tcb)):
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        trainer = _StubTrainer()
        cb = getattr(mod, name)(**kwargs, verbose=0)
        cb.set_trainer(trainer)
        trace = []
        for epoch, d in enumerate(dice):
            cb.on_epoch_end(epoch, {"val_dice": d, "loss": 1.0})
            trace.append((trainer.learning_rate, trainer.stop_training))
        out[pkg] = (trace, trainer.saved,
                    sorted(p.name for p in (tmp_path / pkg).rglob("*.npz")))
    assert out["port"] == out["jax"]


def test_csv_logger_delayed_callback_and_timer(tmp_path):
    path = tmp_path / "logs" / "training.csv"
    csv = tcb.CSVLogger(filename=path)
    csv.on_train_begin()
    csv.on_epoch_end(0, {"loss": 0.5, "lr": 1e-3, "arr": np.ones(2)})
    csv.on_train_end()
    again = tcb.CSVLogger(filename=path)  # appends under the same header
    again.on_train_begin()
    again.on_epoch_end(1, {"lr": 1e-4, "loss": 0.25})
    again.on_train_end()
    assert path.read_text() == "epoch,loss,lr\n0,0.5,0.001\n1,0.25,0.0001\n"
    objs, names = init_callback_objects(
        [{"class_name": "EarlyStopping", "nickname": "es", "start_from": 2,
          "kwargs": {"patience": 1}},
         {"class_name": "TrainTimer", "kwargs": {"verbose": False}}])
    assert isinstance(objs[0], tcb.DelayedCallback) and names["es"] is objs[0]
    trainer = _StubTrainer()
    for cb in objs:
        cb.set_trainer(trainer)
        cb.on_train_begin({})
    stops = []
    for epoch in range(4):
        logs = {"val_dice": 0.5}
        for cb in objs:
            cb.on_epoch_begin(epoch, logs)
            cb.on_epoch_end(epoch, logs)
        stops.append(trainer.stop_training)
        assert "epoch_minutes" in logs and "train_hours" in logs
    # EarlyStopping sees epochs 2 (its first best) and 3 (no improvement)
    assert stops == [False, False, False, True]


def test_prefetched_yields_batches_in_order():
    seq = Replay(n=5)
    got = [X for X, _, _ in prefetched(seq, 4, "cpu")]
    assert len(got) == 4 and seq.calls == [0, 1, 2, 3]
    for i, X in enumerate(got):
        assert torch.equal(X, seq.batches[i][0])
