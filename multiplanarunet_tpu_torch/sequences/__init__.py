"""Batch samplers: the multi-planar training sequence and its factory."""

from multiplanarunet_tpu_torch.augmentation.augmenters import build_augmenters
from multiplanarunet_tpu_torch.image.image_pair_loader import ImagePairLoader
from multiplanarunet_tpu_torch.image.queue.queues import LazyQueue
from multiplanarunet_tpu_torch.sequences.multi_planar import (
    IsotrophicLiveViewSequence2D,
)


class SequenceNotPortedError(ValueError):
    """An intrp_style whose sampler the port does not have."""


_STYLES = {"iso_live": IsotrophicLiveViewSequence2D}
# The JAX package's other samplers (3D boxes, patches)
_NOT_PORTED = ("iso_live_3d", "patches_3d", "sliding_patches_3d")


def get_sequence(data_queue, intrp_style, augmenters=None, logger=None,
                 device=None, **kwargs):
    """The sampler of `intrp_style` over a data queue (as
    `multiplanarunet_tpu/sequences/utils.py:get_sequence`), sampling on
    `device` (the card by default, which raises without one). A bare
    ImagePairLoader is wrapped in a LazyQueue; augmenter config dicts are
    instantiated here."""
    style = intrp_style.lower()
    if style in _NOT_PORTED:
        raise SequenceNotPortedError(
            f"intrp_style {intrp_style!r} is not ported to PyTorch yet "
            f"(ported: {sorted(_STYLES)})")
    if style not in _STYLES:
        raise ValueError(f"Unknown intrp_style '{intrp_style}'; valid: "
                         f"{sorted(_STYLES) + list(_NOT_PORTED)}")
    if isinstance(data_queue, ImagePairLoader):
        data_queue = LazyQueue(data_queue, logger=logger)
    kwargs.pop("list_of_augmenters", None)
    aug_list = build_augmenters(augmenters) if augmenters else None
    return _STYLES[style](data_queue, logger=logger,
                          list_of_augmenters=aug_list, device=device,
                          **kwargs)
