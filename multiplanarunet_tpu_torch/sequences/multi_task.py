"""Multi-task batch sampler (port of
`multiplanarunet_tpu/sequences/multi_task.py`): indexing returns one
batch per task as lists (xs, ys, ws); attributes read fall back to the
first task's sequence, and attributes set go to every task's sequence
(the Trainer's batch size, for one)."""

from __future__ import annotations

from multiplanarunet_tpu_torch.sequences.base_sequence import BaseSequence


class MultiTaskSequence(BaseSequence):
    def __init__(self, sequencers, task_names, no_log=False, logger=None):
        # object.__setattr__: the class's __setattr__ broadcasts
        object.__setattr__(self, "sequences", list(sequencers))
        object.__setattr__(self, "task_names", list(task_names))
        if not no_log and logger:
            logger(f"MultiTaskSequence over tasks: {self.task_names}")

    def __len__(self):
        return int(1e12)

    def __getitem__(self, idx):
        xs, ys, ws = [], [], []
        for seq in self.sequences:
            x, y, w = seq[idx]
            xs.append(x)
            ys.append(y)
            ws.append(w)
        return xs, ys, ws

    def __getattr__(self, name):
        # Only called for names the instance and class lack
        return getattr(self.sequences[0], name)

    def __setattr__(self, name, value):
        for seq in self.sequences:
            setattr(seq, name, value)
