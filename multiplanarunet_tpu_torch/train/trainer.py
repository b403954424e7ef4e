"""Trainer: builds the train and eval steps and drives the epoch loop.

Port of `multiplanarunet_tpu/train/trainer.py`. `compile_model` resolves
the optimizer, loss and metrics by name; `fit` runs the epochs (steps per
epoch = images per epoch // batch size, the Validation callback first, the
next batch sampled one step ahead, per-epoch means of the step logs plus
`lr`) and retries with the batch size lowered by 2 on
torch.cuda.OutOfMemoryError, after freeing the allocator's cached blocks.
The step logs stay on the device through an epoch and are fetched once at
its end. A MultiTaskUNet2D (`multitask`: its n_classes is a list) trains on
the multi-task steps over a MultiTaskSequence's per-task batch lists. `fit`
first saves sample images of a train and a val batch to images/ (unless
no_im); where that fails, a missing matplotlib included, it logs one
warning and trains on, as the JAX package does. `predict_batch` is the
eval-mode forward the image and dice callbacks call. Spans
(`utils.trace`): `train.epoch` (request (epoch, None); it counts the
allocator's cudaMalloc calls as `alloc.cuda_mallocs` when recorded),
`train.step` around each train step call (device time on the caller's
stream, request (epoch, step)), `train.epoch_end` over the log fetch and
the callbacks' `on_epoch_end`, and the prefetch's `train.batch_wait` and
`train.sample`.

Data-parallel, when a process group is active (`parallel.distributed`;
`mp train` starts one under a launch marker or for --num_devices N):
`compile_model` broadcasts rank 0's parameters and buffers (`replicate`)
and gives the train step a DistributedDataParallel model (no buffer
broadcasts: every rank computes the same running statistics from the
global batch). `batch_size` is the global batch: each rank samples its
share (`local_batch_slice`) from its own sampler, whose numpy stream is
seeded per process, and the training sequence's augmenters learn the
share (`Elastic.share`), so that they draw the global batch's parameters
and noise fields and deform this rank's rows of them. A global batch
that the ranks do not divide raises, unless `pad_global_batch` (set by
`mp train --num_devices N`, the counterpart of the JAX package's
one-process N-device mesh): then it is padded to a multiple of the ranks
as that mesh pads it, with rows of weight 0 that enter the BatchNorm
statistics: in training copies of the global batch's first rows, as the
JAX `_shard` pads, gathered from the ranks that own them; in Validation,
which masks them out of its counts, copies of the share's own rows.
Ranks other than the main one drop the callbacks that write files, and
the OOM back-off keeps the global batch a multiple of the ranks.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from multiplanarunet_tpu_torch._device import resolve_device
from multiplanarunet_tpu_torch.callbacks.funcs import init_callback_objects
from multiplanarunet_tpu_torch.callbacks.validation import Validation
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.models import checkpoint
from multiplanarunet_tpu_torch.parallel.distributed import (
    data_group_active,
    is_main_process,
    process_count,
    process_index,
)
from multiplanarunet_tpu_torch.parallel.mesh import (
    pad_batch_to_multiple,
    replicate,
)
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
from multiplanarunet_tpu_torch.utils import trace


class Trainer:
    """Trains a UNet (on `device`: the card by default, which raises
    without one) over batch sampler sequences; data-parallel over the
    ranks of an active process group."""

    def __init__(self, model, logger=None, device=None,
                 pad_global_batch=False):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.logger = logger or ScreenLogger()
        self.pad_global_batch = bool(pad_global_batch)
        # (global batch, padded global batch, rows per rank, this rank's
        # valid rows) of the running fit; None outside fit
        self._share = None
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
        step_model = self.model
        if data_group_active():
            from torch.nn.parallel import DistributedDataParallel

            replicate(self.model)
            step_model = DistributedDataParallel(
                self.model, device_ids=(None if self.device.type == "cpu"
                                        else [self.device]),
                broadcast_buffers=False, init_sync=False)
            self.logger(f"Data-parallel: DistributedDataParallel over "
                        f"{process_count()} process(es), "
                        f"{dist.get_backend()} group; BatchNorm over the "
                        f"global batch")
        self.train_step = train_cls(step_model, self.optimizer, loss_obj,
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
        if not no_im and is_main_process():
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
        try:
            while True:
                try:
                    return self._fit(
                        train, val, batch_size=batch_size, n_epochs=n_epochs,
                        callbacks=callbacks,
                        train_im_per_epoch=train_im_per_epoch,
                        val_im_per_epoch=val_im_per_epoch,
                        init_epoch=init_epoch, verbose=verbose)
                except torch.cuda.OutOfMemoryError:
                    # A multiple of the ranks stays one
                    batch_size -= pad_batch_to_multiple(2, self.world_size)
                    if batch_size < 1:
                        raise
                    self.logger.warn(f"Device OOM; retrying with batch_size="
                                     f"{batch_size}")
                    torch.cuda.empty_cache()
        finally:
            # _fit gives the augmenters each try's share
            self._share_augmenters(train, None)

    # ------------------------------------------------------ data-parallel
    @property
    def world_size(self):
        """Ranks training together (1 without a process group)."""
        return process_count() if data_group_active() else 1

    def _batch_share(self, batch_size):
        """(global, padded global, rows per rank, this rank's valid rows)
        of a global batch."""
        world = self.world_size
        if batch_size % world and not self.pad_global_batch:
            raise ValueError(f"batch_size={batch_size} not divisible by "
                             f"{world} processes")
        padded = pad_batch_to_multiple(batch_size, world)
        local = padded // world
        valid = min(local, max(0, batch_size - process_index() * local))
        return batch_size, padded, local, valid

    def pad_share(self, X, y, w, own_rows=False):
        """A batch this rank sampled, padded to its share of the padded
        global batch: (X, y, w, n_valid), n_valid None where every row is
        valid. Pad rows weigh 0. Global row g past the true batch is a copy
        of global row (g - batch) mod batch, as the JAX package pads with
        the batch's first rows, brought from the rank that owns it
        (`_global_pad_rows`); with own_rows, pad rows are copies of this
        rank's first rows (every row, on a rank whose share holds no valid
        row). For a multi-task batch each task's lists, and n_valid per
        task."""
        if self._share is None or self._share[1] == self._share[0]:
            return X, y, w, None
        if not isinstance(X, (list, tuple)):
            X, y, w, n_valid = self.pad_share([X], [y], [w], own_rows)
            return X[0], y[0], w[0], n_valid[0]
        local, valid = self._share[2:]
        ws = []
        for t in w:
            t = torch.as_tensor(t, dtype=torch.float32)[:valid]
            ws.append(torch.cat([t, t.new_zeros(local - valid)]))
        if own_rows:
            def pad(t):
                idx = torch.arange(local - t.shape[0]) % t.shape[0]
                return torch.cat([t, t[idx.to(t.device)]])
            X, y = [pad(t) for t in X], [pad(t) for t in y]
        else:
            fills = self._global_pad_rows([t for xy in zip(X, y) for t in xy])
            X = [torch.cat([t[:valid], f]) for t, f in zip(X, fills[0::2])]
            y = [torch.cat([t[:valid], f]) for t, f in zip(y, fills[1::2])]
        return X, y, ws, [valid] * len(X)

    def _global_pad_rows(self, tensors):
        """This rank's pad rows [valid, local) of each of `tensors` (its rows
        of a global batch): copies of the global rows (g - batch) mod
        batch, where g is the pad row's place in the padded global batch.
        Global row k lies on rank k // local at k % local, among the first
        min(pad, local) rows of its rank; one all_gather over the data
        group brings those rows of every rank, each row of all the
        tensors as one row of bytes (zeros past the rows a rank holds)."""
        batch, padded, local, valid = self._share
        m = min(padded - batch, local)
        first = process_index() * local
        src = [(g - batch) % batch for g in range(first + valid,
                                                  first + local)]
        src = torch.tensor([k // local * m + k % local for k in src],
                           dtype=torch.long)
        dev = tensors[0].device
        rows = []
        for t in tensors:
            part = t[:m].to(dev).contiguous()
            part = part.reshape(part.shape[0], -1).view(torch.uint8)
            rows.append(torch.cat([part, part.new_zeros(
                m - part.shape[0], part.shape[1])]))
        buf = torch.cat(rows, dim=1)
        if buf.is_cuda and dist.get_backend() == "gloo":
            buf = buf.cpu()       # gloo gathers host tensors only
        parts = [torch.empty_like(buf) for _ in range(self.world_size)]
        dist.all_gather(parts, buf)
        got = torch.cat(parts)[src].to(dev)
        out, at = [], 0
        for t, part in zip(tensors, rows):
            width = part.shape[1]
            out.append(got[:, at:at + width].contiguous().view(t.dtype)
                       .reshape((len(src),) + tuple(t.shape[1:]))
                       .to(t.device))
            at += width
        return out

    def loss_pad_factor(self):
        """Padded global over true global batch: the factor that turns a
        mean over the padded batch (pad rows weigh 0) into the mean over
        the true rows (the JAX package's global pad / global true)."""
        if self._share is None:
            return 1.0
        return self._share[1] / self._share[0]

    def _fit(self, train, val, batch_size, n_epochs, callbacks,
             train_im_per_epoch, val_im_per_epoch, init_epoch, verbose):
        self._share = self._batch_share(batch_size)
        _, padded, local, valid = self._share
        # A rank with no valid row still samples (weight-0) rows
        train.batch_size = valid or local
        if self.world_size > 1:
            self._share_augmenters(train, (batch_size,
                                           process_index() * local))
        steps_per_epoch = max(1, int(train_im_per_epoch / batch_size))
        cb_objs = []
        if val is not None:
            val.batch_size = valid or local
            val_steps = max(1, int(val_im_per_epoch / batch_size))
            cb_objs.append(Validation(val, val_steps, logger=self.logger,
                                      verbose=verbose))
        cb_objs += init_callback_objects(callbacks, self.logger)[0]
        if not is_main_process():
            # One writer per shared project folder: the logs are the same
            # on every rank (all-reduced), so the others drop the
            # callbacks that persist files
            dropped = [type(cb).__name__ for cb in cb_objs
                       if cb.writes_files]
            cb_objs = [cb for cb in cb_objs if not cb.writes_files]
            if dropped:
                self.logger(f"Non-main process: dropped file-writing "
                            f"callbacks {dropped}")
        for cb in cb_objs:
            cb.set_trainer(self)

        history = []
        self.stop_training = False
        for cb in cb_objs:
            cb.on_train_begin({})
        self.logger(f"Training for {n_epochs} epochs of {steps_per_epoch} "
                    f"steps (batch {batch_size}, device {self.device})")
        if self.world_size > 1:
            self.logger(f"Data-parallel: process {process_index() + 1}/"
                        f"{self.world_size}, {local} rows per process"
                        + (f" (global batch padded to {padded}; {valid} "
                           f"valid here)" if padded != batch_size else ""))
        for epoch in range(init_epoch, n_epochs):
            with trace.span("train.epoch", request=(epoch, None),
                            mallocs=self.device):
                logs = {}
                for cb in cb_objs:
                    cb.on_epoch_begin(epoch, logs)
                t0 = time.perf_counter()
                accum = {}
                for step, (X, y, w) in enumerate(prefetched(
                        train, steps_per_epoch, self.device, epoch=epoch)):
                    X, y, w, _ = self.pad_share(X, y, w)
                    with trace.span("train.step", device=self.device,
                                    request=(epoch, step)):
                        step_logs = self.train_step(X, y, w)
                    for k, v in step_logs.items():
                        accum.setdefault(k, []).append(v)
                with trace.span("train.epoch_end"):
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
        self._share = None
        return history

    @staticmethod
    def _share_augmenters(train, share):
        """Set `share` on every augmenter of the training sequence (every
        task's, for a MultiTaskSequence: reading an attribute of one
        reaches the first task's alone)."""
        for seq in getattr(train, "sequences", None) or [train]:
            for aug in getattr(seq, "list_of_augmenters", None) or ():
                aug.share = share

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
