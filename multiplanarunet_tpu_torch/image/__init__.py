"""Per-image volume staging."""

from multiplanarunet_tpu_torch.image.image_pair import ImagePair  # noqa: F401
from multiplanarunet_tpu_torch.image.image_pair_loader import (  # noqa: F401
    ImagePairLoader,
)
