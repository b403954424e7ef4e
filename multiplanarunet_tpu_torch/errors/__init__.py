"""Named exceptions of the port."""

from multiplanarunet_tpu_torch.errors.image_errors import (  # noqa: F401
    NoLabelFileError,
    ReadOnlyAttributeError,
)
from multiplanarunet_tpu_torch.errors.implementation_change_errors import (  # noqa: F401
    NotSparseError,
)
