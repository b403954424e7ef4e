"""Data-parallel mesh helpers over torch.distributed.

Port of `multiplanarunet_tpu/parallel/mesh.py`. The JAX package lays a
1-axis `data` mesh over devices, shards the batch along it and
replicates the parameters; XLA then reduces the gradients. In the port a
mesh axis is a set of ranks, one card each: `get_mesh` is a 1-D
DeviceMesh named ("data",) over the group, `shard_batch` moves this
rank's share of the global batch to its device, and `replicate`
broadcasts a module's (or a state dict's) tensors from rank 0, which is
what makes the replicas start equal. DistributedDataParallel then
averages the gradients (`train/trainer.py`). `batch_sharding` and
`replicated` return the DTensor placements of the same two layouts.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from multiplanarunet_tpu_torch._device import resolve_device

DATA_AXIS = "data"


def _mesh_type():
    """The DeviceMesh device type of the active group: 'cuda' under NCCL,
    'cpu' under gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def get_mesh(devices=None):
    """A 1-D DeviceMesh named ('data',) over every rank of the active
    group, or over the ranks listed in `devices` (a sub-mesh; every rank
    of the group must call it with the same list)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "get_mesh spans the ranks of a process group: start one with "
            "parallel.maybe_initialize_distributed (a launch marker) first")
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    world = dist.get_world_size()
    if devices is None or list(devices) == list(range(world)):
        return init_device_mesh(_mesh_type(), (world,),
                                mesh_dim_names=(DATA_AXIS,))
    return DeviceMesh(_mesh_type(), torch.as_tensor(list(devices)),
                      mesh_dim_names=(DATA_AXIS,))


def batch_sharding(mesh):
    """(mesh, placements) sharding the leading (batch) axis over the data
    axis."""
    from torch.distributed.tensor.placement_types import Shard

    return mesh, [Shard(0)]


def replicated(mesh):
    """(mesh, placements) replicating a tensor on every rank."""
    from torch.distributed.tensor.placement_types import Replicate

    return mesh, [Replicate()]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh=None, device=None):
    """This rank's share of a global batch (a pytree of arrays or tensors:
    its LOCAL slice, as `local_batch_slice` sizes it) as tensors on
    `device`: the card by default (no card raises CudaUnavailableError),
    the CPU only when named. The mesh only names the layout: each rank
    holds its own rows, and no rows cross ranks."""
    device = resolve_device(device)
    return _tree_map(
        lambda x: torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(device, non_blocking=True), batch)


def replicate(tree, mesh=None):
    """Make every rank hold rank 0's values of a module's parameters and
    buffers, or of a (nested) dict of tensors, by broadcasting them in
    place over the default group; returns `tree`. No-op without a
    group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tree
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.state_dict().values())
    else:
        tensors = []
        _tree_map(lambda t: tensors.append(t)
                  if isinstance(t, torch.Tensor) else None, tree)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)
    return tree


def pad_batch_to_multiple(batch_size, n_devices):
    """Smallest batch >= batch_size divisible by n_devices."""
    return -(-int(batch_size) // int(n_devices)) * int(n_devices)
