"""The sequence factory: an intrp_style name -> its sampler over a data
queue (as `multiplanarunet_tpu/sequences/utils.py`)."""

from __future__ import annotations

from multiplanarunet_tpu_torch.augmentation.augmenters import build_augmenters
from multiplanarunet_tpu_torch.image.image_pair_loader import ImagePairLoader
from multiplanarunet_tpu_torch.image.queue.queues import LazyQueue
from multiplanarunet_tpu_torch.sequences.iso_3d import (
    IsotrophicLiveViewSequence3D,
)
from multiplanarunet_tpu_torch.sequences.multi_planar import (
    IsotrophicLiveViewSequence2D,
)
from multiplanarunet_tpu_torch.sequences.patches_3d import (
    PatchSequence3D,
    SlidingPatchSequence3D,
)

_STYLES = {
    "iso_live": IsotrophicLiveViewSequence2D,
    "iso_live_3d": IsotrophicLiveViewSequence3D,
    "patches_3d": PatchSequence3D,
    "sliding_patches_3d": SlidingPatchSequence3D,
}
# styles whose sampler takes no augmenters
_PATCH_STYLES = ("patches_3d", "sliding_patches_3d")


def get_sequence(data_queue, intrp_style, augmenters=None, logger=None,
                 device=None, **kwargs):
    """The sampler of `intrp_style` over a data queue, sampling on
    `device` (the card by default, which raises without one). A bare
    ImagePairLoader is wrapped in a LazyQueue; augmenter config dicts are
    instantiated here (the patch samplers take none)."""
    style = intrp_style.lower()
    if style not in _STYLES:
        raise ValueError(f"Unknown intrp_style '{intrp_style}'; valid: "
                         f"{sorted(_STYLES)}")
    if isinstance(data_queue, ImagePairLoader):
        data_queue = LazyQueue(data_queue, logger=logger)
    kwargs.pop("list_of_augmenters", None)
    if style not in _PATCH_STYLES:
        kwargs["list_of_augmenters"] = (build_augmenters(augmenters)
                                        if augmenters else None)
    return _STYLES[style](data_queue, logger=logger, device=device, **kwargs)
