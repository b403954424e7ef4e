"""The callback base and the callbacks of `mp train`.

Port of `multiplanarunet_tpu/callbacks/callbacks.py`: epoch-level hooks
the Trainer drives with a shared `logs` dict. `ModelCheckPointClean`
saves the best checkpoint (JAX-format .npz) and deletes the previous best,
`EarlyStopping` stops the loop, `ReduceLROnPlateau` multiplies the
optimizer's learning rate on a plateau, `CSVLogger` appends
logs/training.csv (columns: epoch, then the logs' keys sorted),
`TrainTimer` adds epoch_minutes / train_hours, `DelayedCallback` starts a
wrapped callback at a given epoch, `MemoryConsumption` logs the host's
peak RSS, `DividerLine` a rule, `LearningCurve` plots the CSV,
`FGBatchBalancer` sets the sampler's foreground fraction from the
validation recall, `MeanReduceLogArrays` averages array-valued logs,
`PrintLayerWeights` logs parameter statistics, `SavePredictionImages` and
`SaveOutputAs2DImage` draw the model's output on a batch, and `Profiler`
traces chosen epochs with torch.profiler. The plotting callbacks need
matplotlib; where it cannot be imported they log a warning and training
goes on, as in the JAX package.
"""

from __future__ import annotations

import os
import resource
import time
from pathlib import Path

import numpy as np
import torch

from multiplanarunet_tpu_torch.utils import trace


class Callback:
    """Base class; the Trainer assigns itself before training starts.
    `writes_files` marks the callbacks that persist files, which ranks
    other than the main one drop."""

    trainer = None
    writes_files = False

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

    def on_batch_end(self, batch, logs=None):
        """Per-batch hook of the JAX package's base; no Trainer of either
        package calls it."""


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

    writes_files = True

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
    writes_files = True

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

    @property
    def writes_files(self):
        return self.callback.writes_files

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


class MemoryConsumption(Callback):
    """Logs the host's peak RSS every epoch (logs["memory_gib"]); stops
    training over max_gib."""

    def __init__(self, max_gib=None, logger=None, set_limit=False, **kwargs):
        self.max_gib = max_gib
        self.logger = logger

    def on_epoch_end(self, epoch, logs=None):
        rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024 ** 2
        if logs is not None:
            logs["memory_gib"] = rss_gib
        log = self.logger or self.trainer.logger
        log(f"[Memory] RSS ~{rss_gib:.2f} GiB")
        if self.max_gib and rss_gib > self.max_gib:
            log(f"[Memory] exceeds limit {self.max_gib} GiB; stopping.")
            self.trainer.stop_training = True


class DividerLine(Callback):
    def __init__(self, logger=None, **kwargs):
        self.logger = logger

    def on_epoch_end(self, epoch, logs=None):
        (self.logger or self.trainer.logger)("-" * 60)


class LearningCurve(Callback):
    """Re-plots <out_dir>/<fname> from <log_dir>/training.csv each
    epoch."""

    writes_files = True

    def __init__(self, log_dir="logs", out_dir="logs", fname="curve.png",
                 logger=None, **kwargs):
        self.csv_path = Path(log_dir) / "training.csv"
        self.out_path = Path(out_dir) / fname

    def on_epoch_end(self, epoch, logs=None):
        if not self.csv_path.exists():
            return
        try:
            from multiplanarunet_tpu_torch.utils.plotting import (
                plot_training_curves,
            )

            plot_training_curves(self.csv_path, self.out_path)
        except Exception as e:  # plotting must never kill training
            self.trainer.logger.warn(f"LearningCurve failed: {e}")


class FGBatchBalancer(Callback):
    """Sets the train sequence's foreground fraction to 1 - val_recall
    (clipped to [0, 1]); the sampler reads it per batch, so it holds from
    the next epoch's first batch."""

    def __init__(self, train_data=None, logger=None, **kwargs):
        self.train_data = train_data

    def on_epoch_end(self, epoch, logs=None):
        recall = (logs or {}).get("val_recall")
        if recall is None:
            return
        seq = self.train_data or self.trainer.train_sequence
        if seq is None:
            return
        fraction = float(np.clip(1.0 - recall, 0.0, 1.0))
        seq.fg_batch_fraction = fraction
        self.trainer.logger(f"[FGBalancer] fg_batch_fraction -> "
                            f"{fraction:.3f}")


class MeanReduceLogArrays(Callback):
    """Replaces every array-valued logs entry with its mean."""

    def on_epoch_end(self, epoch, logs=None):
        for k, v in list((logs or {}).items()):
            if isinstance(v, (list, tuple, np.ndarray)) and np.ndim(v) > 0:
                logs[k] = float(np.mean(v))


def _sorted_leaves(tree):
    """The arrays of a nested dict in sorted key order (jax's
    tree_leaves order)."""
    if not isinstance(tree, dict):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in _sorted_leaves(tree[k])]


class PrintLayerWeights(Callback):
    """Logs mean, std, min and max of the parameters (BatchNorm running
    statistics left out) every `every` epochs: of the module `layer`
    names in the flax naming the weight files use (e.g. 'encoder_L0'),
    or of all of them."""

    def __init__(self, layer=None, every=1, logger=None, **kwargs):
        self.layer = layer
        self.every = every
        self.logger = logger

    def on_epoch_end(self, epoch, logs=None):
        if epoch % self.every:
            return
        from multiplanarunet_tpu_torch.models.checkpoint import (
            unet_variables_from_model,
        )

        params, _ = unet_variables_from_model(self.trainer.model)
        if self.layer is not None and self.layer in params:
            params = params[self.layer]
        flat = np.concatenate([np.asarray(leaf).ravel()
                               for leaf in _sorted_leaves(params)])
        log = self.logger or self.trainer.logger
        log(f"[Weights{'/' + self.layer if self.layer else ''}] "
            f"mean={flat.mean():.4g} std={flat.std():.4g} "
            f"min={flat.min():.4g} max={flat.max():.4g}")


def _sample_sequence(trainer, *preferred):
    """The first of `preferred` that is set, else the trainer's val then
    train sequence."""
    for seq in preferred + (trainer.val_sequence, trainer.train_sequence):
        if seq is not None:
            return seq
    return None


class SavePredictionImages(Callback):
    """Saves (input | truth | prediction) panels of a batch each epoch to
    <out_dir>/epoch_<e>.png."""

    writes_files = True

    def __init__(self, train_data=None, val_data=None, out_dir="images",
                 logger=None, **kwargs):
        self.train_data = train_data
        self.val_data = val_data
        self.out_dir = Path(out_dir)

    def on_epoch_end(self, epoch, logs=None):
        seq = _sample_sequence(self.trainer, self.val_data, self.train_data)
        if seq is None:
            return
        try:
            from multiplanarunet_tpu_torch.utils.plotting import (
                require_matplotlib,
                save_prediction_panel,
            )

            require_matplotlib()
            X, y, _ = seq[0]
            probs = self.trainer.predict_batch(X)
            self.out_dir.mkdir(parents=True, exist_ok=True)
            save_prediction_panel(X, y, probs,
                                  self.out_dir / f"epoch_{epoch:03d}.png")
        except Exception as e:  # plotting must never kill training
            self.trainer.logger.warn(f"SavePredictionImages failed: {e}")


class Profiler(Callback):
    """torch.profiler trace of the epochs in `epochs`: host activity, and
    the card's kernels when the trainer runs on CUDA. Each traced epoch
    is exported as a Chrome trace, <log_dir>/trace_epoch_<e>.json (the
    JAX package writes a TensorBoard trace of the same epochs; only the
    format differs), where the port's spans (`utils.trace`) show as
    `mp.<name>`. The span recorder is on over a traced epoch; at its end
    one log line per span name gives the spans' count and their summed
    host and device milliseconds, and one line per counter its total,
    beside the trace's path."""

    writes_files = True

    def __init__(self, log_dir="./profile", epochs=(1,), logger=None,
                 **kwargs):
        self.log_dir = Path(log_dir)
        self.epochs = set(epochs)
        self._prof = None
        self._epoch = None
        self._was_recording = False

    def on_epoch_begin(self, epoch, logs=None):
        if epoch in self.epochs and self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(self.trainer.device).type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
            self._epoch = epoch
            self._was_recording = trace.enabled()
            trace.enable()

    def _stop(self):
        """Stop the profiler and the recorder; (trace path, the records)."""
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        if not self._was_recording:
            trace.disable()
        records = trace.take()
        self.log_dir.mkdir(parents=True, exist_ok=True)
        path = self.log_dir / f"trace_epoch_{self._epoch}.json"
        prof.export_chrome_trace(str(path))
        return path, records

    def on_epoch_end(self, epoch, logs=None):
        if self._prof is not None:
            path, records = self._stop()
            log = self.trainer.logger
            log(f"[Profiler] trace written to {path}")
            for name, (n, host, dev) in trace.summary(records).items():
                dev = "-" if dev is None else f"{dev:.3f}"
                log(f"[Profiler] span {name}: {n} x, host {host:.3f} ms, "
                    f"device {dev} ms")
            for name, total in records["counters"].items():
                log(f"[Profiler] counter {name}: {total}")

    def on_train_end(self, logs=None):
        if self._prof is not None:
            self._stop()


class SaveOutputAs2DImage(Callback):
    """Saves the model's per-class output on the first image of a batch
    (the middle slice of a 3D output) each `every` epochs to
    <out_dir>/output_epoch_<e>.png."""

    writes_files = True

    def __init__(self, sequence=None, out_dir="images/outputs", every=1,
                 logger=None, **kwargs):
        self.sequence = sequence
        self.out_dir = Path(out_dir)
        self.every = every

    def on_epoch_end(self, epoch, logs=None):
        if epoch % self.every:
            return
        seq = _sample_sequence(self.trainer, self.sequence)
        if seq is None:
            return
        try:
            from multiplanarunet_tpu_torch.utils.plotting import pyplot

            plt = pyplot()
            X, _, _ = seq[0]
            img = self.trainer.predict_batch(X)[0].float().cpu().numpy()
            if img.ndim == 4:  # 3D output -> middle slice
                img = img[img.shape[0] // 2]
            self.out_dir.mkdir(parents=True, exist_ok=True)
            fig, axes = plt.subplots(1, img.shape[-1],
                                     figsize=(3 * img.shape[-1], 3))
            for c, ax in enumerate(np.atleast_1d(axes)):
                ax.imshow(img[..., c], vmin=0, vmax=1)
                ax.set_title(f"class {c}")
                ax.axis("off")
            fig.tight_layout()
            fig.savefig(self.out_dir / f"output_epoch_{epoch:03d}.png",
                        dpi=80)
            plt.close(fig)
        except Exception as e:
            self.trainer.logger.warn(f"SaveOutputAs2DImage failed: {e}")
