"""A project's train_hparams.yaml, read and edited as text."""

from multiplanarunet_tpu_torch.hyperparameters.hparams import (  # noqa: F401
    VersionController,
    YAMLHParams,
)
