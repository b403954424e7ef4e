"""NIfTI-1 volume IO (numpy only)."""

from multiplanarunet_tpu_torch.io import nifti  # noqa: F401
from multiplanarunet_tpu_torch.io.nifti import (  # noqa: F401
    Nifti1Image,
    NiftiImage,
    load,
    save,
)
