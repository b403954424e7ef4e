"""Losses and evaluation metrics."""

from multiplanarunet_tpu_torch.evaluate.losses import (  # noqa: F401
    LOSSES,
    SparseCategoricalCrossentropy,
    SparseDiceLoss,
    SparseExponentialLogarithmicLoss,
    SparseExpLogDice,
    SparseFocalLoss,
    SparseGeneralizedDiceLoss,
    SparseJaccardDistanceLoss,
)
from multiplanarunet_tpu_torch.evaluate.metrics import (  # noqa: F401
    METRICS,
    class_wise_kappa,
    dice,
    dice_all,
)
