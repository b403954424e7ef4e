"""Name-based resolution of optimizers, losses and metrics.

Port of `multiplanarunet_tpu/train/utils.py`: `init_optimizer` takes the
optimizer name and the Keras-style kwargs of a project's YAML, translates
them to optax's names with the same table (`_KW_MAP`; a key with no
optax counterpart in that optimizer is logged and ignored, so Keras'
learning-rate `decay` is dropped for Adam but becomes RMSprop's `decay`,
as in the JAX package), and gives Adam, Nadam, Adamax and RMSprop Keras'
epsilon 1e-7 only where the config names none. The optimizers themselves
are in `train.optimizers`.
"""

from __future__ import annotations

from multiplanarunet_tpu_torch.errors.implementation_change_errors import (
    NotSparseError,
)
from multiplanarunet_tpu_torch.evaluate.losses import LOSSES
from multiplanarunet_tpu_torch.evaluate.metrics import METRICS
from multiplanarunet_tpu_torch.train.optimizers import OPTIMIZERS

# Keras-style kwarg -> optax kwarg
_KW_MAP = {
    "lr": "learning_rate",
    "beta_1": "b1",
    "beta_2": "b2",
    "epsilon": "eps",
    "rho": "decay",
    "momentum": "momentum",
    "nesterov": "nesterov",
    "weight_decay": "weight_decay",
}


def ensure_sparse(loss_and_metric_names):
    """Raise NotSparseError unless every name uses sparse integer
    targets."""
    for name in loss_and_metric_names:
        if "sparse" not in name.lower():
            raise NotSparseError(
                f"'{name}' does not appear to be a sparse loss/metric. This "
                f"framework uses integer-class targets; use the Sparse* "
                f"variants.")


def translate_optimizer_kwargs(optimizer_name, logger=None, **kwargs):
    """The optax kwargs of `optimizer_name` for Keras-style `kwargs`."""
    if optimizer_name not in OPTIMIZERS:
        raise ValueError(f"Unknown optimizer '{optimizer_name}'. "
                         f"Available: {sorted(OPTIMIZERS)}")
    accepted = set(OPTIMIZERS[optimizer_name].accepted)
    translated = {}
    for k, v in kwargs.items():
        key = _KW_MAP.get(k, k)
        if key in accepted:
            translated[key] = v
        elif logger is not None:
            logger(f"[OBS] optimizer kwarg '{k}' not supported by optax "
                   f"{optimizer_name}; ignored")
    # Keras-named optimizers take Keras' epsilon default (1e-7), not
    # optax's (1e-8), unless the config names one
    if (optimizer_name in ("Adam", "Nadam", "Adamax", "RMSprop")
            and "eps" in accepted and "eps" not in translated):
        translated["eps"] = 1e-7
    return translated


def init_optimizer(optimizer_name, params, logger=None, **kwargs):
    """The optimizer `optimizer_name` over `params` (float32 tensors on one
    device), with its learning rate settable between steps."""
    translated = translate_optimizer_kwargs(optimizer_name, logger, **kwargs)
    if logger:
        logger(f"Optimizer: {optimizer_name}({translated}), optax update "
               f"rules")
    return OPTIMIZERS[optimizer_name](params, **translated)


def init_losses(loss_names, logger=None, **loss_kwargs):
    losses = []
    for name in _as_list(loss_names):
        if name not in LOSSES:
            raise ValueError(f"Unknown loss '{name}'. Available: "
                             f"{sorted(LOSSES)}")
        losses.append(LOSSES[name](**(loss_kwargs or {})))
        if logger:
            logger(f"Loss: {losses[-1]}")
    return losses


def init_metrics(metric_names, logger=None):
    metrics = {}
    for name in _as_list(metric_names):
        if name not in METRICS:
            raise ValueError(f"Unknown metric '{name}'. Available: "
                             f"{sorted(METRICS)}")
        metrics[name] = METRICS[name]
    return metrics


def _as_list(obj):
    if obj is None:
        return []
    return obj if isinstance(obj, (list, tuple)) else [obj]
