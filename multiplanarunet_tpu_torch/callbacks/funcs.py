"""Callback objects from YAML config dicts (as
`multiplanarunet_tpu/callbacks/funcs.py`): each entry is {class_name,
kwargs, nickname?, pass_logger?, start_from?}; `start_from` wraps the
callback in DelayedCallback. The registry holds the sixteen callback
classes the JAX package resolves by name; any other name raises
CallbackNotPortedError: a configured callback is never skipped."""

from __future__ import annotations

from multiplanarunet_tpu_torch.callbacks import callbacks as cb_mod
from multiplanarunet_tpu_torch.callbacks.validation import (
    ValDiceScores,
    Validation,
)

CALLBACKS = {cls.__name__: cls for cls in (
    cb_mod.ModelCheckPointClean, cb_mod.EarlyStopping,
    cb_mod.ReduceLROnPlateau, cb_mod.CSVLogger, cb_mod.TrainTimer,
    cb_mod.MemoryConsumption, cb_mod.DividerLine, cb_mod.LearningCurve,
    cb_mod.FGBatchBalancer, cb_mod.MeanReduceLogArrays,
    cb_mod.PrintLayerWeights, cb_mod.SavePredictionImages, cb_mod.Profiler,
    cb_mod.SaveOutputAs2DImage, Validation, ValDiceScores)}


class CallbackNotPortedError(ValueError):
    """A callback class name the registry does not hold."""


def init_callback_objects(callbacks, logger=None):
    """Instantiate a list of callback config dicts (callback objects pass
    through). Returns (objects, {nickname: object})."""
    initialized, by_name = [], {}
    for spec in callbacks or []:
        if isinstance(spec, cb_mod.Callback):
            initialized.append(spec)
            continue
        spec = dict(spec)
        name = spec["class_name"]
        if name not in CALLBACKS:
            raise CallbackNotPortedError(
                f"Unknown callback class {name!r} (available: "
                f"{sorted(CALLBACKS)})")
        kwargs = dict(spec.get("kwargs", {}))
        if spec.get("pass_logger"):
            kwargs["logger"] = logger
        obj = CALLBACKS[name](**kwargs)
        start_from = spec.get("start_from", 0)
        if start_from:
            obj = cb_mod.DelayedCallback(obj, start_from=start_from)
        if spec.get("nickname"):
            by_name[spec["nickname"]] = obj
        if logger:
            logger(f"Callback: {name}({kwargs})")
        initialized.append(obj)
    return initialized, by_name


def remove_validation_callbacks(callbacks, logger=None):
    """Drop the callback configs that monitor or consume validation data
    (--no_val)."""
    kept = []
    for spec in callbacks or []:
        if isinstance(spec, dict) and "val" in str(spec.get("kwargs", {})):
            if logger:
                logger(f"[OBS] Removing callback {spec.get('class_name')} "
                       f"(validation-dependent)")
            continue
        kept.append(spec)
    return kept
