"""Multi-process execution over torch.distributed (`distributed`, `mesh`)
and the device-side data structures shared by the samplers
(`volume_pool`)."""

from multiplanarunet_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    batch_sharding,
    get_mesh,
    pad_batch_to_multiple,
    replicate,
    replicated,
    shard_batch,
)
from multiplanarunet_tpu_torch.parallel.distributed import (
    broadcast_from_main,
    initialize_distributed,
    is_main_process,
    local_batch_slice,
    maybe_initialize_distributed,
    process_barrier,
    task_group_mesh,
)
