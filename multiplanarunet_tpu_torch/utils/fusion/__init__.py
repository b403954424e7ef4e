"""Fused multi-view inference and the fusion-training helpers."""

from multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict import (  # noqa: F401
    MultiViewPredictor,
    map_real_space_pred,
    pred_3D_iso,
    predict_3D_patches,
    predict_3D_patches_binary,
    predict_volume,
)
from multiplanarunet_tpu_torch.utils.fusion.fusion_training import (  # noqa: F401
    predict_and_map,
    stack_collections,
)
