"""Trainer: builds the train and eval steps and drives the epoch loop.

Port of `multiplanarunet_tpu/train/trainer.py` for one device.
`compile_model` resolves the optimizer, loss and metrics by name; `fit`
runs the epochs (steps per epoch = images per epoch // batch size, the
Validation callback first, the next batch sampled one step ahead,
per-epoch means of the step logs plus `lr`) and retries with the batch
size lowered by 2 on torch.cuda.OutOfMemoryError, after freeing the
allocator's cached blocks. The step logs stay on the device through an
epoch and are fetched once at its end. A MultiTaskUNet2D (`multitask`:
its n_classes is a list) trains on the multi-task steps over a
MultiTaskSequence's per-task batch lists. `fit` first saves sample
images of a train and a val batch to images/ (unless no_im); where that
fails, a missing matplotlib included, it logs one warning and trains on,
as the JAX package does. `predict_batch` is the eval-mode forward the
image and dice callbacks call.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from multiplanarunet_tpu_torch._device import resolve_device
from multiplanarunet_tpu_torch.callbacks.funcs import init_callback_objects
from multiplanarunet_tpu_torch.callbacks.validation import Validation
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.models import checkpoint
from multiplanarunet_tpu_torch.sequences.base_sequence import prefetched
from multiplanarunet_tpu_torch.train.train_step import (
    EvalStep,
    MultiTaskEvalStep,
    MultiTaskTrainStep,
    TrainStep,
    forward_channels_last,
    forward_tasks,
)
from multiplanarunet_tpu_torch.train.utils import (
    ensure_sparse,
    init_losses,
    init_metrics,
    init_optimizer,
)


class Trainer:
    """Trains a UNet (on `device`: the card by default, which raises
    without one) over batch sampler sequences."""

    def __init__(self, model, logger=None, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.logger = logger or ScreenLogger()
        self.optimizer = None
        self.train_step = None
        self.eval_step = None
        self.stop_training = False
        self.train_sequence = None
        self.val_sequence = None

    # ------------------------------------------------------------- compile
    def compile_model(self, optimizer, optimizer_kwargs=None, loss=None,
                      metrics=(), loss_kwargs=None, check_sparse=True,
                      l1_reg=0.0, l2_reg=0.0):
        metrics = list(metrics or [])
        if check_sparse:
            ensure_sparse([loss] + metrics)
        self.optimizer = init_optimizer(optimizer, self.model.parameters(),
                                        logger=self.logger,
                                        **(optimizer_kwargs or {}))
        loss_obj = init_losses(loss, logger=self.logger,
                               **(loss_kwargs or {}))[0]
        metric_fns = init_metrics(metrics, logger=self.logger)
        train_cls, eval_cls = ((MultiTaskTrainStep, MultiTaskEvalStep)
                               if self.multitask else (TrainStep, EvalStep))
        self.train_step = train_cls(self.model, self.optimizer, loss_obj,
                                    metric_fns, l1_reg=l1_reg, l2_reg=l2_reg)
        self.eval_step = eval_cls(self.model, loss_obj, metric_fns,
                                  self.n_classes)
        self.logger("Trainer compiled.")
        return self

    # --------------------------------------------------------------- state
    @property
    def multitask(self):
        """True for a model taking per-task input lists
        (MultiTaskUNet2D)."""
        return isinstance(getattr(self.model, "n_classes", None),
                          (list, tuple))

    @property
    def n_classes(self):
        return self.model.n_classes

    @property
    def learning_rate(self):
        return self.optimizer.learning_rate

    def set_learning_rate(self, lr):
        self.optimizer.learning_rate = lr

    def save_checkpoint(self, path, epoch=None):
        checkpoint.save_unet_weights(
            path, self.model,
            meta={"epoch": epoch} if epoch is not None else None)

    @torch.no_grad()
    def predict_batch(self, X):
        """The model's eval-mode forward over a channels-last batch (B,
        *spatial, C), in its compute dtype on the trainer's device: the
        probabilities (B, *spatial, n_classes), float32 on the device (a
        list of such per task for a multi-task model, given a list)."""
        self.model.eval()
        if self.multitask:
            return forward_tasks(self.model,
                                 [torch.as_tensor(x, device=self.device)
                                  for x in X])
        return forward_channels_last(self.model,
                                     torch.as_tensor(X, device=self.device))

    # ----------------------------------------------------------------- fit
    def fit(self, train, val=None, batch_size=16, n_epochs=10, callbacks=(),
            train_im_per_epoch=2500, val_im_per_epoch=3500, init_epoch=0,
            verbose=True, no_im=False):
        """Run the epoch loop; returns the list of per-epoch logs. Retries
        with batch_size - 2 on a device out-of-memory error."""
        self.train_sequence = train
        self.val_sequence = val
        if not no_im:
            try:
                from multiplanarunet_tpu_torch.utils import plotting

                # Without matplotlib no batch is drawn, as in the JAX
                # package, whose import of its plotting module fails first
                plotting.require_matplotlib()
                plotting.save_images(train[0],
                                     val[0] if val is not None else None,
                                     Path("images"), self.logger)
            except Exception as e:
                self.logger.warn(f"Could not save sample images: {e}")
        while True:
            try:
                return self._fit(
                    train, val, batch_size=batch_size, n_epochs=n_epochs,
                    callbacks=callbacks,
                    train_im_per_epoch=train_im_per_epoch,
                    val_im_per_epoch=val_im_per_epoch, init_epoch=init_epoch,
                    verbose=verbose)
            except torch.cuda.OutOfMemoryError:
                batch_size -= 2
                if batch_size < 1:
                    raise
                self.logger.warn(f"Device OOM; retrying with batch_size="
                                 f"{batch_size}")
                torch.cuda.empty_cache()

    def _fit(self, train, val, batch_size, n_epochs, callbacks,
             train_im_per_epoch, val_im_per_epoch, init_epoch, verbose):
        train.batch_size = batch_size
        steps_per_epoch = max(1, int(train_im_per_epoch / batch_size))
        cb_objs = []
        if val is not None:
            val.batch_size = batch_size
            val_steps = max(1, int(val_im_per_epoch / batch_size))
            cb_objs.append(Validation(val, val_steps, logger=self.logger,
                                      verbose=verbose))
        cb_objs += init_callback_objects(callbacks, self.logger)[0]
        for cb in cb_objs:
            cb.set_trainer(self)

        history = []
        self.stop_training = False
        for cb in cb_objs:
            cb.on_train_begin({})
        self.logger(f"Training for {n_epochs} epochs of {steps_per_epoch} "
                    f"steps (batch {batch_size}, device {self.device})")
        for epoch in range(init_epoch, n_epochs):
            logs = {}
            for cb in cb_objs:
                cb.on_epoch_begin(epoch, logs)
            t0 = time.perf_counter()
            accum = {}
            for X, y, w in prefetched(train, steps_per_epoch, self.device):
                for k, v in self.train_step(X, y, w).items():
                    accum.setdefault(k, []).append(v)
            # One host fetch per epoch for the step logs
            keys = list(accum)
            means = torch.stack([torch.stack(accum[k]).float().mean()
                                 for k in keys]).cpu().numpy()
            logs.update({k: float(m) for k, m in zip(keys, means)})
            logs["lr"] = self.learning_rate
            train_seconds = time.perf_counter() - t0
            for cb in cb_objs:
                cb.on_epoch_end(epoch, logs)
            if verbose:
                summary = " - ".join(
                    f"{k}: {v:.4f}" for k, v in logs.items()
                    if np.isscalar(v) and np.isfinite(v))
                self.logger(f"Epoch {epoch + 1}/{n_epochs} - {summary}")
                self.logger(f"Epoch {epoch + 1} wall: train loop "
                            f"{train_seconds:.3f} s ({steps_per_epoch} "
                            f"steps), callbacks incl. validation "
                            f"{time.perf_counter() - t0 - train_seconds:.3f}"
                            f" s")
            history.append(logs)
            if self.stop_training:
                break
        for cb in cb_objs:
            cb.on_train_end({})
        self._stop_queues(train, val)
        return history

    @staticmethod
    def _stop_queues(train, val):
        """De-register the datasets of LimitationQueues from their loading
        pool (its daemon threads end with the process), every task's for
        a MultiTaskSequence."""
        seqs = []
        for seq in (train, val):
            seqs += getattr(seq, "sequences", None) or [seq]
        for seq in seqs:
            queue = getattr(seq, "image_pair_queue", None)
            pool = getattr(queue, "loading_pool", None)
            if pool is not None:
                pool.de_register_dataset(queue.dataset.identifier)
