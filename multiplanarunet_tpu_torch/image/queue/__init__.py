"""Image residency queues."""

from multiplanarunet_tpu_torch.image.queue.queues import (  # noqa: F401
    BaseQueue,
    EagerQueue,
    LazyQueue,
    LimitationQueue,
    LoadingPool,
    get_data_queues,
    validate_queue_type,
)
