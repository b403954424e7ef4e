"""Multi-process execution over torch.distributed.

Port of `multiplanarunet_tpu/parallel/distributed.py`. The port runs one
process per card, as DistributedDataParallel expects; where the JAX
package drives N local devices from one process, the port starts N
processes. The launch markers are the JAX package's, so one launcher
drives both packages:

  * MPUNET_COORDINATOR_ADDRESS (host:port), MPUNET_NUM_PROCESSES and
    MPUNET_PROCESS_ID, set by a job launcher or by `mp train --num_devices
    N` itself;
  * failing those, torchrun's RANK / WORLD_SIZE / MASTER_ADDR /
    MASTER_PORT (the cluster markers the JAX package leaves to
    jax.distributed).

`maybe_initialize_distributed` starts the default process group over a
tcp:// address with an explicit timeout: NCCL when the rank's device is a
card (the rank's own card when no device is named), gloo on the CPU
(named as `device="cpu"`) or as the caller names it. The host collectives
(`process_barrier`, `broadcast_from_main`) go through a separate gloo
group with the JAX package's one-hour barrier timeout: ranks reach them
minutes apart, after each has predicted its own share of a cohort, and a
device collective would die of its watchdog first. The scripts that only
coordinate hosts (`mp predict`, `predict_3D`, `train_fusion`) start a gloo
group alone, which is then the host group too.

A rank's card is cuda:LOCAL_RANK (`rank_device`); LOCAL_RANK defaults to
the process id modulo the visible cards. A device named with an index
(`--device cuda:0`) overrides it, so that ranks can share one card on the
paths that use no device collective.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from multiplanarunet_tpu_torch._device import require_cuda, resolve_device

# The JAX package's host barrier timeout (process_barrier's 3,600,000 ms)
HOST_TIMEOUT = timedelta(hours=1)
# The default group's collective timeout (the device collectives of a
# training step, and the start-up rendezvous)
DEVICE_TIMEOUT = timedelta(minutes=30)

_host_group = None


def launch_config():
    """(address 'host:port', number of processes, process id) of a
    multi-process launch, from the MPUNET_* markers or torchrun's, or None
    when neither is set."""
    addr = os.environ.get("MPUNET_COORDINATOR_ADDRESS")
    if addr:
        return (addr, int(os.environ["MPUNET_NUM_PROCESSES"]),
                int(os.environ["MPUNET_PROCESS_ID"]))
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                     "MASTER_PORT")):
        return (f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
                int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]))
    return None


def process_count():
    """Processes of the active group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    """This process's rank in the active group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank():
    """This process's index among the processes of its host: LOCAL_RANK
    where the launcher sets it, else the process id modulo the visible
    cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    cfg = launch_config()
    if cfg is None:
        return 0
    return cfg[2] % max(1, torch.cuda.device_count())


def rank_device(device="cuda"):
    """The torch.device this rank runs on: for 'cuda' without an index
    under a launch marker, cuda:local_rank(); a device with an index, or
    the CPU, as given; any card through require_cuda (no card raises)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None \
            and launch_config() is not None:
        return require_cuda(local_rank())
    return resolve_device(device)


def maybe_initialize_distributed(logger=None, device=None, backend=None):
    """Entry-point hook (`mp train` / `mp predict` / `mp predict_3D` / `mp
    train_fusion`): start the process group when a launch marker is set
    (see `launch_config`), no-op otherwise. `device` is this rank's
    device, this rank's card when None (it picks the backend when
    `backend` is None). Returns (process count, process index)."""
    cfg = launch_config()
    if cfg is None:
        return process_count(), process_index()
    n, i = initialize_distributed(*cfg, device=device, backend=backend)
    if logger is not None:
        logger(f"Distributed: process {i + 1}/{n} "
               f"({dist.get_backend()} group, device "
               f"{device or f'cuda:{torch.cuda.current_device()}'})")
    return n, i


def initialize_distributed(coordinator_address, num_processes, process_id,
                           device=None, backend=None, timeout=None):
    """Start the default process group at tcp://coordinator_address (no-op
    if one is active) on `device`: this rank's card when None or 'cuda'
    without an index (cuda:LOCAL_RANK, else process_id modulo the visible
    cards; set as the current device; no card raises
    CudaUnavailableError), the CPU only when named. `backend` or, by
    default, nccl for a CUDA `device` and gloo on the CPU, with `timeout`
    (DEVICE_TIMEOUT by default; a gloo
    group that also carries the host collectives gets HOST_TIMEOUT), and
    the gloo host group beside an nccl one. A start-up that fails raises:
    an explicit configuration never falls back to running each process
    alone. Returns (process count, process index)."""
    global _host_group
    num_processes, process_id = int(num_processes), int(process_id)
    if dist.is_initialized():
        if dist.get_world_size() != num_processes:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} processes is "
                f"already active; asked for {num_processes}")
        return process_count(), process_index()
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        index = device.index
        if index is None:
            index = int(os.environ.get(
                "LOCAL_RANK", process_id % max(1, torch.cuda.device_count())))
        device = require_cuda(index)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if timeout is None:
        timeout = HOST_TIMEOUT if backend == "gloo" else DEVICE_TIMEOUT
    if device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, timeout=timeout)
        _host_group = (None if backend == "gloo" else
                       dist.new_group(backend="gloo", timeout=HOST_TIMEOUT))
    except Exception as e:
        if dist.is_initialized():
            dist.destroy_process_group()
        raise RuntimeError(
            f"torch.distributed start-up failed for an explicit "
            f"{num_processes}-process configuration (process {process_id}, "
            f"{backend} at {coordinator_address}): {e}") from e
    return process_count(), process_index()


def shutdown_distributed():
    """Destroy the process group (no-op without one)."""
    global _host_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None


def task_group_mesh(n_groups, group_index=None):
    """Split the ranks into `n_groups` contiguous groups and return (a 1-D
    'data' DeviceMesh over this rank's group, its group index). Every rank
    takes part in building the (n_groups, ranks per group) mesh; a
    group_index other than this rank's raises, since a DeviceMesh only
    spans groups its rank belongs to."""
    from torch.distributed.device_mesh import init_device_mesh

    from multiplanarunet_tpu_torch.parallel.mesh import DATA_AXIS, _mesh_type

    world = process_count()
    if world % n_groups:
        raise ValueError(f"{world} processes do not split into {n_groups} "
                         f"groups")
    per_group = world // n_groups
    own = process_index() // per_group
    if group_index is not None and int(group_index) != own:
        raise ValueError(f"process {process_index()} lies in group {own}, "
                         f"not {group_index}")
    mesh = init_device_mesh(_mesh_type(), (n_groups, per_group),
                            mesh_dim_names=("group", DATA_AXIS))
    return mesh[DATA_AXIS], own


def local_batch_slice(global_batch_size):
    """(start, size) of this process's share of a global batch."""
    per_proc = int(global_batch_size) // process_count()
    return process_index() * per_proc, per_proc


def is_main_process():
    """True in the process that owns the shared files (result CSVs,
    checkpoints, views.npz, the YAML); always True without a group. Reads
    MPUNET_PROCESS_ID, then RANK, before it asks torch.distributed, so it
    is safe to call before start-up (e.g. from YAMLHParams.save_current)."""
    for marker in ("MPUNET_PROCESS_ID", "RANK"):
        pid = os.environ.get(marker)
        if pid is not None:
            return int(pid) == 0
    return process_index() == 0


def process_barrier(name, timeout_ms=3_600_000):
    """Block until every process of the group reaches the barrier `name`
    (no-op without a group), on the gloo host group with an explicit
    timeout; a rank that does not arrive in time makes it raise, naming
    the barrier."""
    if process_count() == 1:
        return
    try:
        dist.monitored_barrier(group=_host_group,
                               timeout=timedelta(milliseconds=timeout_ms),
                               wait_all_ranks=True)
    except RuntimeError as e:
        raise RuntimeError(f"process barrier {name!r} failed: {e}") from e


def broadcast_from_main(array):
    """The main process's value of `array` in every process (no-op
    without a group), over the host group. Keeps random run artifacts
    (the view axes of `load_or_create_views`, the fusion image set)
    identical across a group."""
    if process_count() == 1:
        return array
    box = [np.asarray(array) if is_main_process() else None]
    dist.broadcast_object_list(box, src=0, group=_host_group)
    return box[0]


# --------------------------------------------------- device collectives
def data_group_active():
    """True when training runs data-parallel: a default process group is
    active (a world of 1 included, so one rank runs the same path)."""
    return dist.is_available() and dist.is_initialized()


def all_reduce_mean(values):
    """{key: 0-d tensor} -> the same keys holding the means over the ranks,
    through one all_reduce of their stack (no-op without a group)."""
    if not data_group_active():
        return values
    keys = list(values)
    stacked = torch.stack([values[k].detach().float() for k in keys])
    dist.all_reduce(stacked)
    stacked /= process_count()
    return dict(zip(keys, stacked.unbind()))
