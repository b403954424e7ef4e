"""Array-backed feeder sequences (port of
`multiplanarunet_tpu/sequences/simple_sequences.py`)."""

from __future__ import annotations

import numpy as np
import torch

from multiplanarunet_tpu_torch._device import resolve_device
from multiplanarunet_tpu_torch.sequences.base_sequence import BaseSequence


class RandomDataFeeder(BaseSequence):
    """Feeds random subsets of fixed (X, y) arrays as batches: indices
    drawn with replacement from numpy's global stream, as the JAX
    package draws them; X and y come as tensors on `device` (the card by
    default, which raises without one), the sample weights as numpy."""

    def __init__(self, X, y, batch_size, sample_weights=None, device=None,
                 **kwargs):
        super().__init__()
        self.device = resolve_device(device)
        self.X = torch.as_tensor(np.asarray(X), device=self.device)
        self.y = torch.as_tensor(np.asarray(y), device=self.device)
        self.sample_weights = (np.ones(len(self.X), np.float32)
                               if sample_weights is None
                               else np.asarray(sample_weights, np.float32))
        self.batch_size = batch_size

    def __len__(self):
        return max(1, int(np.ceil(len(self.X) / self.batch_size)))

    def __getitem__(self, idx):
        sel = np.random.randint(0, len(self.X), self.batch_size)
        index = torch.as_tensor(sel, device=self.device)
        return self.X[index], self.y[index], self.sample_weights[sel]
