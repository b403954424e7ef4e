"""Model construction from a project's hyperparameters, and the
continue-training restore.

Port of `multiplanarunet_tpu/models/model_init.py` for the 2D `UNet`,
the `UNet3D` and the `MultiTaskUNet2D`: the model from the build group,
its weights from the JAX package's checkpoint files, and
`model_initializer` for `mp train` (a fresh glorot-uniform init from a
seed, `--continue_training` from the last '@epoch_NN' checkpoint with the
epoch and learning rate of logs/training.csv, or `--initialize_from` a
weight file, restored by name).
"""

from __future__ import annotations

from pathlib import Path

import torch

from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.models import checkpoint
from multiplanarunet_tpu_torch.models.multitask_unet import MultiTaskUNet2D
from multiplanarunet_tpu_torch.models.unet import UNet, glorot_init
from multiplanarunet_tpu_torch.models.unet3d import UNet3D
from multiplanarunet_tpu_torch.utils.utils import (
    clear_csv_after_epoch,
    get_last_model,
    get_lr_at_epoch,
)

MODELS = {"UNet": UNet, "UNet3D": UNet3D,
          "MultiTaskUNet2D": MultiTaskUNet2D}
# build-group fields the U-Nets take; the JAX models' other fields (the
# single-task dim, img_rows/img_cols, l1_reg/l2_reg, and the exact
# inference restructurings dilated_upconv / subpixel_decoder) do not
# change what they compute, and keys that are not model fields are
# ignored, as the JAX package ignores them
_UNET_FIELDS = ("n_classes", "n_channels", "depth", "complexity_factor",
                "init_filters", "kernel_size", "activation",
                "out_activation")
# the multi-task model's per-task lists come with the task names and dims
_FIELDS = {"UNet": _UNET_FIELDS, "UNet3D": _UNET_FIELDS,
           "MultiTaskUNet2D": ("task_names", "dim") + _UNET_FIELDS}


class UnsupportedModelError(ValueError):
    """A build configuration the port cannot build."""


def build_model(build_hparams, mixed_precision=False, logger=None):
    """A UNet, UNet3D or MultiTaskUNet2D (eval mode, on the CPU) from the
    'build' group; bf16 compute when mixed_precision."""
    logger = logger or ScreenLogger()
    build = dict(build_hparams)
    name = build.get("model_class_name")
    if name not in MODELS:
        raise UnsupportedModelError(
            f"model_class_name {name!r} is not ported to PyTorch yet (the "
            f"port builds {sorted(MODELS)})")
    if str(build.get("padding", "same")).lower() != "same":
        raise UnsupportedModelError(
            f"padding {build['padding']!r}: the port's U-Nets pad 'same'")
    if build.get("flatten_output"):
        raise UnsupportedModelError(
            "flatten_output: the port's U-Nets return (B, C, *spatial)")
    kwargs = {k: build[k] for k in _FIELDS[name]
              if build.get(k) is not None}
    if mixed_precision:
        kwargs["dtype"] = torch.bfloat16
    model = MODELS[name](**kwargs).eval()
    logger(f"Built model: {name}({kwargs})")
    return model


def load_unet_weights(model, path):
    """Load a JAX-format UNet, UNet3D or MultiTaskUNet2D checkpoint (.npz)
    into `model`."""
    params, batch_stats, _ = checkpoint.load_weights(path)
    model.load_state_dict(
        checkpoint.unet_state_dict_from_jax(params, batch_stats, model))
    return model


def model_initializer(hparams, continue_training=False, project_dir=None,
                      logger=None, initialize_from=None):
    """Build a model from hparams (`build_model`) and initialise it:
    glorot-uniform from seed 0 (the JAX package initialises from
    PRNGKey(0)), then, with
    continue_training, the last '@epoch_NN' checkpoint of
    <project_dir>/model restored by name, the rows of
    logs/training.csv past its epoch dropped and its learning rate
    recovered; or with initialize_from, that file restored by name.
    Returns (model on the CPU in train mode, init_epoch, restored_lr or
    None)."""
    logger = logger or ScreenLogger()
    mixed = bool(hparams.get("fit", {}).get("mixed_precision", False))
    model = build_model(hparams["build"], mixed_precision=mixed,
                        logger=logger)
    glorot_init(model, seed=0)

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
            clear_csv_after_epoch(init_epoch - 1, csv_path)
    elif initialize_from:
        weights_path = initialize_from

    if weights_path:
        logger(f"Restoring weights (by name) from {weights_path}")
        params, batch_stats, _ = checkpoint.load_weights(weights_path)
        n = checkpoint.restore_by_name(model, params, batch_stats, logger)
        logger(f"Restored {n} parameter arrays (epoch={init_epoch})")
    return model.train(), init_epoch, restored_lr
