"""The callback base and the default callbacks of `mp train`.

Port of the default set of `multiplanarunet_tpu/callbacks/callbacks.py`:
epoch-level hooks the Trainer drives with a shared `logs` dict.
`ModelCheckPointClean` saves the best checkpoint (JAX-format .npz) and
deletes the previous best, `EarlyStopping` stops the loop,
`ReduceLROnPlateau` multiplies the optimizer's learning rate on a plateau,
`CSVLogger` appends logs/training.csv (columns: epoch, then the logs'
keys sorted), `TrainTimer` adds epoch_minutes / train_hours, and
`DelayedCallback` starts a wrapped callback at a given epoch. The JAX
package's other callbacks are not ported (`callbacks.funcs` raises a
named error for them).
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np


class Callback:
    """Base class; the Trainer assigns itself before training starts."""

    trainer = None

    def set_trainer(self, trainer):
        self.trainer = trainer

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass


def _improved(current, best, mode, min_delta=0.0):
    if mode == "max":
        return current > best + min_delta
    return current < best - min_delta


def _scalar_logs(logs):
    return {k: v for k, v in (logs or {}).items()
            if np.isscalar(v) or np.ndim(v) == 0}


class ModelCheckPointClean(Callback):
    """Save the best checkpoint and delete the previously saved best file.
    `filepath` may format `epoch` (1-based) and any logs key, e.g.
    './model/@epoch_{epoch:02d}_val_dice_{val_dice:.5f}.npz'."""

    def __init__(self, filepath, monitor="val_dice", save_best_only=True,
                 save_weights_only=True, verbose=1, mode="max", **kwargs):
        self.filepath = str(filepath)
        self.monitor = monitor
        self.save_best_only = save_best_only
        self.verbose = verbose
        self.mode = mode
        self.best = -np.inf if mode == "max" else np.inf
        self.previous_path = None

    def on_epoch_end(self, epoch, logs=None):
        current = (logs or {}).get(self.monitor)
        if current is None:
            return
        if self.save_best_only and not _improved(current, self.best,
                                                 self.mode):
            return
        self.best = current
        fmt = {"epoch": epoch + 1,
               **{k: float(v) for k, v in _scalar_logs(logs).items()}}
        path = Path(self.filepath.format(**fmt))
        if not path.suffix:
            path = path.with_suffix(".npz")
        self.trainer.save_checkpoint(path, epoch=epoch + 1)
        if self.previous_path and self.previous_path != path:
            try:
                os.remove(self.previous_path)
            except OSError:
                pass
        self.previous_path = path
        if self.verbose:
            self.trainer.logger(f"[MCP] epoch {epoch + 1}: {self.monitor}="
                                f"{current:.5f} saved to {path}")


class EarlyStopping(Callback):
    def __init__(self, monitor="val_dice", min_delta=0, patience=10,
                 verbose=1, mode="max", **kwargs):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.verbose = verbose
        self.mode = mode
        self.best = -np.inf if mode == "max" else np.inf
        self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        current = (logs or {}).get(self.monitor)
        if current is None:
            return
        if _improved(current, self.best, self.mode, self.min_delta):
            self.best = current
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            self.trainer.stop_training = True
            if self.verbose:
                self.trainer.logger(
                    f"[EarlyStopping] no {self.monitor} improvement in "
                    f"{self.patience} epochs; stopping.")


class ReduceLROnPlateau(Callback):
    """Multiplies the optimizer's learning rate by `factor` on a plateau."""

    def __init__(self, monitor="val_dice", factor=0.9, patience=2, verbose=1,
                 mode="max", min_delta=1e-4, min_lr=1e-8, **kwargs):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.mode = mode
        self.min_delta = min_delta
        self.min_lr = min_lr
        self.best = -np.inf if mode == "max" else np.inf
        self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        current = (logs or {}).get(self.monitor)
        if current is None:
            return
        if _improved(current, self.best, self.mode, self.min_delta):
            self.best = current
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            old = self.trainer.learning_rate
            new = max(old * self.factor, self.min_lr)
            self.trainer.set_learning_rate(new)
            self.wait = 0
            if self.verbose:
                self.trainer.logger(f"[RLOP] lr {old:.3g} -> {new:.3g}")


class CSVLogger(Callback):
    def __init__(self, filename="logs/training.csv", separator=",",
                 append=True, **kwargs):
        self.filename = Path(filename)
        self.sep = separator
        self.append = append
        self._keys = None
        self._file = None

    def on_train_begin(self, logs=None):
        self.filename.parent.mkdir(parents=True, exist_ok=True)
        exists = self.filename.exists() and self.append
        if exists and self.filename.stat().st_size > 0:
            with open(self.filename) as f:
                header = f.readline().strip()
            if header:
                self._keys = header.split(self.sep)[1:]
        self._file = open(self.filename, "a" if self.append else "w")

    def on_epoch_end(self, epoch, logs=None):
        logs = _scalar_logs(logs)
        if self._keys is None:
            self._keys = sorted(logs)
            self._file.write(self.sep.join(["epoch"] + self._keys) + "\n")
        row = [str(epoch)] + [f"{float(logs[k]):.6g}" if k in logs else ""
                              for k in self._keys]
        self._file.write(self.sep.join(row) + "\n")
        self._file.flush()

    def on_train_end(self, logs=None):
        if self._file:
            self._file.close()
            self._file = None


class TrainTimer(Callback):
    """Logs per-epoch and total training time, adds them to the logs, and
    stops past max_minutes."""

    def __init__(self, logger=None, max_minutes=None, verbose=1, **kwargs):
        self.logger = logger
        self.max_minutes = max_minutes
        self.verbose = verbose
        self.train_begin = None
        self.epoch_begin = None

    def on_train_begin(self, logs=None):
        self.train_begin = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch_begin = time.time()

    def on_epoch_end(self, epoch, logs=None):
        now = time.time()
        epoch_minutes = (now - self.epoch_begin) / 60
        total_minutes = (now - self.train_begin) / 60
        if logs is not None:
            logs["epoch_minutes"] = epoch_minutes
            logs["train_hours"] = total_minutes / 60
        log = self.logger or self.trainer.logger
        if self.verbose:
            log(f"[TrainTimer] epoch {epoch}: {epoch_minutes:.2f} min "
                f"(total {total_minutes / 60:.2f} h)")
        if self.max_minutes and total_minutes > self.max_minutes:
            log(f"[TrainTimer] max_minutes={self.max_minutes} exceeded; "
                f"stopping.")
            self.trainer.stop_training = True


class DelayedCallback(Callback):
    """Wraps another callback, activating its epoch hooks from epoch
    `start_from`."""

    def __init__(self, callback, start_from=0, logger=None, **kwargs):
        self.callback = callback
        self.start_from = start_from

    def set_trainer(self, trainer):
        self.trainer = trainer
        self.callback.set_trainer(trainer)

    def on_train_begin(self, logs=None):
        self.callback.on_train_begin(logs)

    def on_train_end(self, logs=None):
        self.callback.on_train_end(logs)

    def on_epoch_begin(self, epoch, logs=None):
        if epoch >= self.start_from:
            self.callback.on_epoch_begin(epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        if epoch >= self.start_from:
            self.callback.on_epoch_end(epoch, logs)
