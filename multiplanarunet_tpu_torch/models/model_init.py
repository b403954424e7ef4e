"""Model construction from a project's `build` hyperparameters.

Port of the build half of `multiplanarunet_tpu/models/model_init.py` for
inference: the 2D `UNet` from the build group, its weights from the JAX
package's checkpoint files.
"""

from __future__ import annotations

import torch

from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.models import checkpoint
from multiplanarunet_tpu_torch.models.unet import UNet

# build-group fields the UNet takes; the JAX model's other fields (dim,
# img_rows/img_cols, l1_reg/l2_reg) do not change inference, and keys
# that are not UNet fields are ignored, as the JAX package ignores them
_UNET_FIELDS = ("n_classes", "n_channels", "depth", "complexity_factor",
                "init_filters", "kernel_size", "activation",
                "out_activation")


class UnsupportedModelError(ValueError):
    """A build configuration the port cannot build."""


def build_model(build_hparams, mixed_precision=False, logger=None):
    """An inference UNet (eval mode, on the CPU) from the 'build' group;
    bf16 compute when mixed_precision."""
    logger = logger or ScreenLogger()
    build = dict(build_hparams)
    name = build.get("model_class_name")
    if name != "UNet":
        raise UnsupportedModelError(
            f"model_class_name {name!r} is not ported to PyTorch yet (the "
            f"port builds 'UNet')")
    if str(build.get("padding", "same")).lower() != "same":
        raise UnsupportedModelError(
            f"padding {build['padding']!r}: the port's UNet pads 'same'")
    if build.get("flatten_output"):
        raise UnsupportedModelError(
            "flatten_output: the port's UNet returns (B, C, H, W)")
    kwargs = {k: build[k] for k in _UNET_FIELDS if build.get(k) is not None}
    if mixed_precision:
        kwargs["dtype"] = torch.bfloat16
    model = UNet(**kwargs).eval()
    logger(f"Built model: {name}({kwargs})")
    return model


def load_unet_weights(model, path):
    """Load a JAX-format UNet checkpoint (.npz) into `model`."""
    params, batch_stats, _ = checkpoint.load_weights(path)
    model.load_state_dict(
        checkpoint.unet_state_dict_from_jax(params, batch_stats, model))
    return model
