"""Per-channel volume normalization (numpy) and data preparation."""

from multiplanarunet_tpu_torch.preprocessing.scaling import (  # noqa: F401
    MultiChannelScaler,
    NoOpScaler,
    apply_scaling,
    assert_scaler,
    get_scaler,
)
