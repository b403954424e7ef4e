"""The library entry points that place data or start a process group run
on the card unless the caller names the CPU.

`shard_batch`, `initialize_distributed`, `maybe_initialize_distributed`
(under a launch marker) and `plane_points`: with no device (or 'cuda')
and no card, each raises `CudaUnavailableError` and starts no process
group, as `resolve_device` does for the other entry points; with
`device="cpu"` each gives what it gave before the card became the
default (CPU tensors, a gloo group). The card itself is driven by
chip_smoke.py's multi-device phase.
"""
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from multiplanarunet_tpu_torch._device import CudaUnavailableError
from multiplanarunet_tpu_torch.ops.geometry import plane_basis
from multiplanarunet_tpu_torch.ops.interp import plane_points
from multiplanarunet_tpu_torch.parallel import distributed as tdist
from multiplanarunet_tpu_torch.parallel.mesh import shard_batch
from tests.torch_projects import torch_threads  # noqa: F401


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _shard_batch(device, monkeypatch):
    x, y = shard_batch((np.ones((2, 3), np.float32), torch.zeros(2)),
                       device=device)
    assert x.device == y.device
    return x.device


def _initialize(device, monkeypatch):
    tdist.initialize_distributed(f"localhost:{_free_port()}", 1, 0,
                                 device=device)
    return dist.get_backend()


def _maybe_initialize(device, monkeypatch):
    monkeypatch.setenv("MPUNET_COORDINATOR_ADDRESS",
                       f"localhost:{_free_port()}")
    monkeypatch.setenv("MPUNET_NUM_PROCESSES", "1")
    monkeypatch.setenv("MPUNET_PROCESS_ID", "0")
    assert tdist.maybe_initialize_distributed(device=device) == (1, 0)
    return dist.get_backend()


def _plane_points(device, monkeypatch):
    pts = plane_points(plane_basis(np.array([0.3, -0.5, 0.8])), 1.5, 31.0,
                       8, device=device)
    assert pts.shape == (8, 8, 3) and pts.dtype == torch.float32
    return pts.device


# entry point -> what it gives with device="cpu"
ENTRIES = {
    "shard_batch": (_shard_batch, torch.device("cpu")),
    "initialize_distributed": (_initialize, "gloo"),
    "maybe_initialize_distributed": (_maybe_initialize, "gloo"),
    "plane_points": (_plane_points, torch.device("cpu")),
}


@pytest.fixture(autouse=True)
def _no_group_left(monkeypatch):
    for marker in ("LOCAL_RANK", "RANK", "WORLD_SIZE", "MASTER_ADDR",
                   "MASTER_PORT", "MPUNET_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(marker, raising=False)
    yield
    tdist.shutdown_distributed()


@pytest.mark.parametrize("device", [None, "cuda"])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_no_device_means_the_card_and_raises_without_one(entry, device,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError):
        ENTRIES[entry][0](device, monkeypatch)
    assert not dist.is_initialized()


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_the_cpu_when_named(entry, monkeypatch):
    fn, expected = ENTRIES[entry]
    assert fn("cpu", monkeypatch) == expected
