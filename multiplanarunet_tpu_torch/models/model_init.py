"""Model construction from a project's hyperparameters, and the
continue-training restore.

Port of `multiplanarunet_tpu/models/model_init.py` for the 2D `UNet`,
the `UNet3D`, the `MultiTaskUNet2D` and the `FusionModel`: the model from
the build group,
its weights from the JAX package's checkpoint files, and
`model_initializer` for `mp train` (a fresh init equal to the JAX
package's from PRNGKey(0), `--continue_training` from the last
'@epoch_NN' checkpoint with the epoch and learning rate of
logs/training.csv, or `--initialize_from` a weight file, restored by
name).
"""

from __future__ import annotations

import inspect
from pathlib import Path

import torch

from multiplanarunet_tpu_torch._device import resolve_device
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.models import checkpoint
from multiplanarunet_tpu_torch.models.fusion_model import FusionModel
from multiplanarunet_tpu_torch.models.multitask_unet import MultiTaskUNet2D
from multiplanarunet_tpu_torch.models.unet import UNet, glorot_init, init_unet
from multiplanarunet_tpu_torch.models.unet3d import UNet3D
from multiplanarunet_tpu_torch.ops import prng
from multiplanarunet_tpu_torch.parallel.distributed import is_main_process
from multiplanarunet_tpu_torch.utils.utils import (
    clear_csv_after_epoch,
    get_last_model,
    get_lr_at_epoch,
)

MODELS = {"UNet": UNet, "UNet3D": UNet3D,
          "MultiTaskUNet2D": MultiTaskUNet2D, "FusionModel": FusionModel}


def _build_kwargs(cls, build):
    """The build group's entries that are fields of the port's `cls` (its
    constructor's parameters; `dtype` comes from mixed_precision), as
    the JAX package passes each class the fields it takes: the 2D UNet
    takes the inference forms and lane_pad, UNet3D the two decoder forms,
    MultiTaskUNet2D its per-task lists. Keys that are not fields (dim of
    a single-task model, l1_reg/l2_reg, ...) are ignored, as there."""
    fields = set(inspect.signature(cls).parameters) - {"dtype"}
    return {k: v for k, v in build.items() if k in fields and v is not None}


class UnsupportedModelError(ValueError):
    """A build configuration the port cannot build."""


def build_model(build_hparams, mixed_precision=False, logger=None):
    """A UNet, UNet3D, MultiTaskUNet2D or FusionModel (eval mode, on the
    CPU) from the 'build' group; bf16 compute when mixed_precision (for
    the classes that have a compute dtype). `flatten_output` makes the
    U-Nets return (B, prod(spatial), n_classes). Every U-Net pads 'same':
    a `padding` of another value is logged and ignored, as the JAX models
    store that field and never read it."""
    logger = logger or ScreenLogger()
    build = dict(build_hparams)
    name = build.get("model_class_name")
    if name not in MODELS:
        raise UnsupportedModelError(
            f"model_class_name {name!r} is not ported to PyTorch yet (the "
            f"port builds {sorted(MODELS)})")
    if str(build.get("padding") or "same").lower() != "same":
        logger.warn(f"padding {build['padding']!r} in the build group: the "
                    f"U-Nets pad 'same' whatever it says, as in the JAX "
                    f"package")
    cls = MODELS[name]
    kwargs = _build_kwargs(cls, build)
    if mixed_precision and "dtype" in inspect.signature(cls).parameters:
        kwargs["dtype"] = torch.bfloat16
    model = cls(**kwargs).eval()
    logger(f"Built model: {name}({kwargs})")
    return model


def load_unet_weights(model, path):
    """Load a JAX-format UNet, UNet3D or MultiTaskUNet2D checkpoint (.npz)
    into `model`."""
    params, batch_stats, _ = checkpoint.load_weights(path)
    model.load_state_dict(
        checkpoint.unet_state_dict_from_jax(params, batch_stats, model))
    return model


def init_model_variables(model, key=None, device=None):
    """The variables the JAX package's `init_model_variables` gives the
    same model from `key` (a `prng.PRNGKey`, PRNGKey(0) when None):
    {"params": ..., "batch_stats": ...} in flax's layout, as tensors on
    `device` (the card unless the caller names the CPU); a FusionModel's
    are constant, {"params": {"fusion": {"W": ones, "b": zeros}}}."""
    if isinstance(model, FusionModel):
        device = resolve_device(device)
        return {"params": {"fusion": {
            name: torch.as_tensor(v, device=device)
            for name, v in model.init_params()["fusion"].items()}}}
    key = prng.PRNGKey(0) if key is None else key
    params, batch_stats = init_unet(model, key, device)
    return {"params": params, "batch_stats": batch_stats}


def model_initializer(hparams, continue_training=False, project_dir=None,
                      logger=None, initialize_from=None, device=None):
    """Build a model from hparams (`build_model`) and initialise it with
    the JAX package's initial weights from PRNGKey(0) (`glorot_init`,
    drawn on `device`: the card unless the caller names the CPU), then,
    with continue_training, the last '@epoch_NN' checkpoint of
    <project_dir>/model restored by name, the rows of
    logs/training.csv past its epoch dropped and its learning rate
    recovered; or with initialize_from, that file restored by name.
    Returns (model on the CPU in train mode, init_epoch, restored_lr or
    None)."""
    logger = logger or ScreenLogger()
    mixed = bool(hparams.get("fit", {}).get("mixed_precision", False))
    model = build_model(hparams["build"], mixed_precision=mixed,
                        logger=logger)
    if not isinstance(model, FusionModel):
        glorot_init(model, seed=0, device=device)

    init_epoch, restored_lr = 0, None
    weights_path = None
    if continue_training:
        if project_dir is None:
            raise ValueError("continue_training requires a project_dir")
        weights_path, init_epoch = get_last_model(Path(project_dir) / "model")
        if weights_path is None:
            logger.warn("No previous checkpoint found; training from scratch.")
        else:
            # Checkpoint names carry the 1-based count of completed epochs;
            # CSV rows are 0-based epoch indices, so training resumes at
            # index init_epoch and the rows kept are those < init_epoch
            csv_path = Path(project_dir) / "logs" / "training.csv"
            restored_lr, _ = get_lr_at_epoch(init_epoch - 1, csv_path.parent)
            if is_main_process():  # the one writer of the shared file
                clear_csv_after_epoch(init_epoch - 1, csv_path)
    elif initialize_from:
        weights_path = initialize_from

    if weights_path:
        logger(f"Restoring weights (by name) from {weights_path}")
        params, batch_stats, _ = checkpoint.load_weights(weights_path)
        n = checkpoint.restore_by_name(model, params, batch_stats, logger)
        logger(f"Restored {n} parameter arrays (epoch={init_epoch})")
    return model.train(), init_epoch, restored_lr
