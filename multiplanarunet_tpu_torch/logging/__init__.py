"""Project loggers and evaluation result tables."""

from multiplanarunet_tpu_torch.logging.loggers import (  # noqa: F401
    Logger,
    ScreenLogger,
)
