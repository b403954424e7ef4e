"""Shear resampling (numpy planner, CUDA pass kernel, torch executor),
the gathers and the elastic deformation."""

from multiplanarunet_tpu_torch.ops import elastic, geometry, interp  # noqa: F401
