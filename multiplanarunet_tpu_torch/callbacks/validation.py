"""Validation callback: epoch evaluation with exact per-class statistics.

Port of `multiplanarunet_tpu/callbacks/validation.py:Validation` (single
device). At every epoch end it runs the eval step over `steps`
validation batches (sampled one batch ahead), sums the batch logs and the
int32 per-class (tp, rel, sel) counts on the device, fetches them once,
and writes into the logs: val_<key> (the mean of each eval-step log:
val_loss and the in-step metrics), and val_precision, val_recall and
val_dice (per-class values from the summed counts, averaged over the
classes present in the labels, background left out). For a multi-task
trainer the counts are per task: each task's mean dice goes to
val_task_{t}/dice, and val_precision, val_recall and val_dice are the
means over the tasks.

`ValDiceScores` (`validation.py:ValDiceScores` of the JAX package) is the
light epoch metric over fixed (X, y) arrays: the trainer's predict_batch
in chunks, the argmax on the device, one fetch of class ids per chunk,
and the mean foreground dice into logs["val_dice"].
"""

from __future__ import annotations

import numpy as np
import torch

from multiplanarunet_tpu_torch.callbacks.callbacks import Callback
from multiplanarunet_tpu_torch.evaluate.metrics import (
    dice_all,
    precision_recall_dice,
)
from multiplanarunet_tpu_torch.sequences.base_sequence import prefetched


class Validation(Callback):
    def __init__(self, val_sequence, steps, logger=None, verbose=True,
                 ignore_bg=True, **kwargs):
        self.sequence = val_sequence
        self.steps = int(steps)
        self.logger = logger
        self.verbose = verbose
        self.ignore_bg = ignore_bg

    def _log(self):
        return self.logger or self.trainer.logger

    def evaluate(self):
        """(summed eval-step logs, per task a (tp, rel, sel) triple of
        int64 numpy) over the validation batches, fetched once."""
        trainer = self.trainer
        sums, counts = None, None
        for X, y, w in prefetched(self.sequence, self.steps, trainer.device):
            step_logs, step_counts = trainer.eval_step(X, y, w)
            if not trainer.multitask:
                step_counts = (step_counts,)
            if sums is None:
                sums, counts = dict(step_logs), step_counts
            else:
                sums = {k: sums[k] + v for k, v in step_logs.items()}
                counts = [[a + b for a, b in zip(task, step_task)]
                          for task, step_task in zip(counts, step_counts)]
        keys = list(sums)
        fetched = torch.stack([sums[k].float() for k in keys]).cpu().numpy()
        return (dict(zip(keys, fetched)),
                [tuple(c.cpu().numpy().astype(np.int64) for c in task)
                 for task in counts])

    def on_epoch_end(self, epoch, logs=None):
        logs = logs if logs is not None else {}
        multitask = self.trainer.multitask
        sums, task_counts = self.evaluate()
        for key, total in sums.items():
            logs[f"val_{key}"] = float(total) / self.steps
        tables, means = [], []
        for t, (tp, rel, sel) in enumerate(task_counts):
            table, mean = precision_recall_dice(tp, rel, sel,
                                                ignore_bg=self.ignore_bg)
            tables.append(table)
            means.append(mean)
            if multitask:
                logs[f"val_task_{t}/dice"] = float(mean[2])
        # Over tasks, each is the task mean (one task: its own value)
        mp, mr, md = (float(np.mean(m)) for m in zip(*means))
        logs["val_precision"] = mp
        logs["val_recall"] = mr
        logs["val_dice"] = md
        if self.verbose:
            log = self._log()
            log(f"\n--- Validation epoch {epoch} "
                f"(loss={logs.get('val_loss', float('nan')):.4f}) ---")
            for t, ((precision, recall, dice), (tmp, tmr, tmd)) in \
                    enumerate(zip(tables, means)):
                if multitask:
                    log(f"[task {t}]")
                classes = np.arange(1 if self.ignore_bg else 0,
                                    len(task_counts[t][0]))
                log(f"{'class':>8} {'precision':>10} {'recall':>10} "
                    f"{'dice':>10}")
                for i, c in enumerate(classes):
                    log(f"{c:>8} {precision[i]:>10.4f} {recall[i]:>10.4f} "
                        f"{dice[i]:>10.4f}")
                log(f"{'mean':>8} {tmp:>10.4f} {tmr:>10.4f} {tmd:>10.4f}")


class ValDiceScores(Callback):
    """Mean foreground dice of the trainer's model over fixed validation
    arrays (X, y), into logs["val_dice"]."""

    def __init__(self, validation_data, n_classes, batch_size=2 ** 17,
                 logger=None, **kwargs):
        self.X_val, self.y_val = validation_data
        self.n_classes = int(n_classes)
        self.batch_size = int(batch_size)
        self.logger = logger

    def eval(self):
        preds = []
        for i in range(0, len(self.X_val), self.batch_size):
            out = self.trainer.predict_batch(self.X_val[i:i + self.batch_size])
            preds.append(torch.argmax(out, dim=-1).cpu().numpy())
        pred = np.concatenate(preds)
        y = self.y_val
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        dices = dice_all(y.squeeze(), pred, n_classes=self.n_classes,
                         ignore_zero=True)
        return np.nanmean(dices)

    def on_epoch_end(self, epoch, logs=None):
        mean_dice = float(self.eval())
        if logs is not None:
            logs["val_dice"] = mean_dice
        (self.logger or self.trainer.logger)(
            f"[ValDiceScores] epoch {epoch}: val_dice={mean_dice:.5f}")
