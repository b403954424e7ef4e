"""Base batch-sampler API (as `multiplanarunet_tpu/sequences/
base_sequence.py`): a sequence is an indexable, endless source of (X, y, w)
batches; the Trainer imposes the epoch length. `prefetched` runs a
sequence one batch ahead of its consumer."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


class BaseSequence:
    def __init__(self):
        self._batch_size = None

    def __len__(self):
        return int(1e12)

    def __getitem__(self, idx):
        raise NotImplementedError

    def seed(self):
        """Re-seed numpy once per process, from fresh entropy and the pid,
        so samplers in several processes draw differently."""
        pid = os.getpid()
        if getattr(self, "_seeded_pid", None) != pid:
            np.random.seed((np.random.SeedSequence().entropy + pid) % (2**31))
            self._seeded_pid = pid

    @property
    def batch_size(self):
        return self._batch_size

    @batch_size.setter
    def batch_size(self, value):
        if value is None or value < 0:
            raise ValueError(f"Invalid batch size {value}")
        self._batch_size = int(value)

    @property
    def n_samples(self):
        """len(self): the nominal, endless length (the Trainer sets the
        epoch's)."""
        return len(self)


def _tensors(part):
    """The tensors of a batch part: one, or a list of them per task."""
    return list(part) if isinstance(part, (list, tuple)) else [part]


def prefetched(sequence, n_batches, device):
    """Yield sequence[0 .. n_batches-1], each sampled in a worker thread
    while the caller works on the one before (one-deep prefetch).

    On a CUDA device the worker samples on a stream of its own, so its
    gathers and host fetches do not wait behind the caller's queued
    work; the caller's stream waits for an event recorded after each
    batch, and the batch tensors (every task's, for a multi-task batch of
    lists) are marked as used on the caller's stream (`record_stream`)
    before the allocator may reuse them."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def work(i):
        if stream is None:
            return sequence[i], None
        with torch.cuda.stream(stream):
            batch = sequence[i]
            done = torch.cuda.Event()
            done.record(stream)
        return batch, done

    with ThreadPoolExecutor(max_workers=1) as worker:
        future = worker.submit(work, 0)
        for i in range(n_batches):
            (X, y, w), done = future.result()
            if i + 1 < n_batches:
                future = worker.submit(work, i + 1)
            if done is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(done)
                for t in _tensors(X) + _tensors(y):
                    t.record_stream(current)
            yield X, y, w
