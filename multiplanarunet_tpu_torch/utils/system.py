"""Device and host-resource reporting over torch.cuda.

Port of `multiplanarunet_tpu/utils/system.py`: the devices are the CUDA
cards torch sees (none without one: the list is empty and never turns
into the CPU), `device_memory_stats` reads the caching allocator per card
(`bytes_in_use` is `torch.cuda.memory_allocated`), and `DeviceMonitor`
keeps the monitor-object API of the reference's GPUMonitor (`stop()`,
`await_and_set_free_devices()`) without a process: an optional thread
logs each card's bytes in use every `interval_s` seconds."""

from __future__ import annotations

import os
import resource
import threading
import time

import torch


def get_devices():
    """The CUDA cards torch sees, as torch.device objects."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def describe_devices():
    """One line per card: index, platform, name."""
    return "\n".join(f"[{d.index}] cuda {torch.cuda.get_device_name(d)}"
                     for d in get_devices())


def device_memory_stats():
    """{card index: allocator stats}: bytes_in_use (memory_allocated),
    peak_bytes_in_use (max_memory_allocated), bytes_reserved
    (memory_reserved) and bytes_limit (the card's total memory)."""
    return {d.index: {
        "bytes_in_use": torch.cuda.memory_allocated(d),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(d),
        "bytes_reserved": torch.cuda.memory_reserved(d),
        "bytes_limit": torch.cuda.get_device_properties(d).total_memory,
    } for d in get_devices()}


def host_rss_gib():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024 ** 2


def host_core_count():
    return os.cpu_count() or 1


class DeviceMonitor:
    """API-compatible stand-in for the reference's GPUMonitor process.

    With `interval_s`, a daemon thread logs every card's bytes in use each
    interval and keeps (time.perf_counter(), card, bytes) in `samples`;
    `stop()` ends it. No subprocesses, no environment mutation."""

    def __init__(self, logger=None, interval_s=None):
        self.logger = logger
        self.samples = []
        self._stop = threading.Event()
        self._thread = None
        if interval_s:
            self._thread = threading.Thread(
                target=self._loop, args=(interval_s,), daemon=True)
            self._thread.start()

    def _log(self, msg):
        (self.logger or print)(msg)

    def _loop(self, interval_s):
        while not self._stop.wait(interval_s):
            for dev_id, s in device_memory_stats().items():
                n = s["bytes_in_use"]
                self.samples.append((time.perf_counter(), dev_id, n))
                self._log(f"[DeviceMonitor] dev {dev_id}: "
                          f"{n / 1024 ** 3:.2f} GiB in use ({n} bytes)")

    @property
    def free_GPUs(self):  # legacy name
        return list(range(len(get_devices())))

    def await_and_set_free_devices(self, N=1, sleep_seconds=0):
        """Every card torch sees counts as free; returns the first N
        indices."""
        if sleep_seconds:
            time.sleep(sleep_seconds)
        return self.free_GPUs[:N]

    # The reference's method name
    await_and_set_free_GPU = await_and_set_free_devices

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1)
