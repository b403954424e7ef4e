"""The train and eval steps.

Port of `multiplanarunet_tpu/train/train_step.py` (single device). A train
step is: forward in train mode (BatchNorm over the batch's statistics,
running statistics updated), the loss with sample weights, the L1/L2
penalty over the parameters with ndim > 1, backward, the optimizer update
and the in-step metrics. Under mixed precision the model keeps float32
parameters and statistics and runs its convolutions in bf16, its
BatchNorm reductions and out conv in float32, as the JAX model does; bf16
needs no loss scaling, and none is used.

Batches come from the sequences in the JAX package's channels-last
layout: images (B, *spatial, C), integer labels (B, *spatial, 1), sample
weights (B,), for 2D slices and 3D boxes alike. The steps
return their logs as 0-d tensors on the device, so the caller decides
when to fetch them. The eval step also returns the int32 per-class
(tp, rel = |y == c|, sel = |pred == c|) counts of the batch.

The multi-task steps (`make_multitask_train_step` / `_eval_step` of the
JAX package) take lists with one batch per task, whose shapes may differ,
through a MultiTaskUNet2D: the loss is the mean of the per-task losses
(plus the penalty), so each step updates the shared encoder from every
task; the logs add task_{t}/loss and task_{t}/<metric>, and the eval step
returns a tuple of per-task (tp, rel, sel) counts.
"""

from __future__ import annotations

import torch


def reg_penalty(params, l1_reg=0.0, l2_reg=0.0):
    """l2 * sum(p^2) + l1 * sum(|p|) over the parameters with ndim > 1
    (conv kernels), or 0.0 when both are off."""
    if not l1_reg and not l2_reg:
        return 0.0
    leaves = [p for p in params if p.dim() > 1]
    penalty = 0.0
    if l2_reg:
        penalty = penalty + l2_reg * sum(torch.sum(p * p) for p in leaves)
    if l1_reg:
        penalty = penalty + l1_reg * sum(torch.sum(torch.abs(p))
                                         for p in leaves)
    return penalty


def forward_channels_last(model, x):
    """model (channels first) over a channels-last batch (B, *spatial,
    C) of any spatial rank; probabilities with classes last."""
    return model(x.movedim(-1, 1)).movedim(1, -1)


def _weights(w, device):
    return torch.as_tensor(w, dtype=torch.float32).to(device,
                                                      non_blocking=True)


class TrainStep:
    """(x, y, w) -> logs: one optimisation step of `model`."""

    def __init__(self, model, optimizer, loss_obj, metric_fns, l1_reg=0.0,
                 l2_reg=0.0):
        self.model = model
        self.optimizer = optimizer
        self.loss_obj = loss_obj
        self.metric_fns = dict(metric_fns)
        self.l1_reg = float(l1_reg or 0.0)
        self.l2_reg = float(l2_reg or 0.0)
        self._params = list(model.parameters())

    def __call__(self, x, y, w):
        self.model.train()
        out = forward_channels_last(self.model, x)
        loss = self.loss_obj(y, out, sample_weight=_weights(w, out.device))
        loss = loss + reg_penalty(self._params, self.l1_reg, self.l2_reg)
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step()
        logs = {"loss": loss.detach()}
        with torch.no_grad():
            out = out.detach()
            for name, fn in self.metric_fns.items():
                logs[name] = fn(y, out)
        return logs


def class_counts(y, out, n_classes):
    """int32 (tp, rel, sel) per class of integer labels y (B, ..., 1) or
    (B, ...) against the argmax of probabilities out (B, ..., C); labels
    outside [0, n_classes) count nowhere."""
    if y.shape[-1] == 1 and y.dim() == out.dim():
        y = y[..., 0]
    t = y.reshape(-1).long()
    p = torch.argmax(out, dim=-1).reshape(-1)
    ok = (t >= 0) & (t < n_classes)
    t = torch.where(ok, t, n_classes)
    tp = torch.where(t == p, t, n_classes)
    counts = [torch.bincount(v, minlength=n_classes + 1)[:n_classes]
              for v in (tp, t, p)]
    return tuple(c.to(torch.int32) for c in counts)


class EvalStep:
    """(x, y, w) -> (logs, (tp, rel, sel)) of `model` in eval mode."""

    def __init__(self, model, loss_obj, metric_fns, n_classes):
        self.model = model
        self.loss_obj = loss_obj
        self.metric_fns = dict(metric_fns)
        self.n_classes = int(n_classes)

    @torch.no_grad()
    def __call__(self, x, y, w):
        self.model.eval()
        out = forward_channels_last(self.model, x)
        logs = {"loss": self.loss_obj(y, out,
                                      sample_weight=_weights(w, out.device))}
        for name, fn in self.metric_fns.items():
            logs[name] = fn(y, out)
        return logs, class_counts(y, out, self.n_classes)


def forward_tasks(model, xs):
    """A multi-task model over channels-last batches, one per task."""
    return [o.movedim(1, -1)
            for o in model([x.movedim(-1, 1) for x in xs])]


def _task_logs(metric_fns, ys, outs, losses):
    logs = {}
    for t, (y, out, loss) in enumerate(zip(ys, outs, losses)):
        logs[f"task_{t}/loss"] = loss.detach()
        for name, fn in metric_fns.items():
            logs[f"task_{t}/{name}"] = fn(y, out)
    return logs


class MultiTaskTrainStep(TrainStep):
    """(xs, ys, ws) lists per task -> logs: one optimisation step of a
    MultiTaskUNet2D."""

    def __call__(self, xs, ys, ws):
        self.model.train()
        outs = forward_tasks(self.model, xs)
        losses = [self.loss_obj(y, out, sample_weight=_weights(w, out.device))
                  for y, out, w in zip(ys, outs, ws)]
        loss = sum(losses) / len(losses)
        loss = loss + reg_penalty(self._params, self.l1_reg, self.l2_reg)
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step()
        with torch.no_grad():
            return {"loss": loss.detach(),
                    **_task_logs(self.metric_fns, ys,
                                 [o.detach() for o in outs], losses)}


class MultiTaskEvalStep:
    """(xs, ys, ws) lists per task -> (logs, ((tp, rel, sel), ...) per
    task) of a MultiTaskUNet2D in eval mode."""

    def __init__(self, model, loss_obj, metric_fns, n_classes_per_task):
        self.model = model
        self.loss_obj = loss_obj
        self.metric_fns = dict(metric_fns)
        self.n_classes = [int(n) for n in n_classes_per_task]

    @torch.no_grad()
    def __call__(self, xs, ys, ws):
        self.model.eval()
        outs = forward_tasks(self.model, xs)
        losses = [self.loss_obj(y, out, sample_weight=_weights(w, out.device))
                  for y, out, w in zip(ys, outs, ws)]
        logs = {"loss": sum(losses) / len(losses),
                **_task_logs(self.metric_fns, ys, outs, losses)}
        return logs, tuple(class_counts(y, out, n)
                           for y, out, n in zip(ys, outs, self.n_classes))
