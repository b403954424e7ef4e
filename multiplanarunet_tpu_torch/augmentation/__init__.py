"""Batch augmenters applied on the device."""

from multiplanarunet_tpu_torch.augmentation.augmenters import (  # noqa: F401
    AUGMENTERS,
    Elastic2D,
    Elastic3D,
    build_augmenters,
)
