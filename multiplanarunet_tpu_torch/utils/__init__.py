"""Utilities."""

from multiplanarunet_tpu_torch.utils.utils import (  # noqa: F401
    await_PIDs,
    create_folders,
    ensure_list_or_tuple,
    get_best_model,
    get_last_model,
    highlighted,
    pred_to_class,
)
