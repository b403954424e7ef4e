"""Host utilities of `mp predict`: checkpoint selection, folders, PID
waiting (the parts of `multiplanarunet_tpu/utils/utils.py` it uses)."""

from __future__ import annotations

import os
import re
import time
from pathlib import Path


def ensure_list_or_tuple(obj):
    return obj if isinstance(obj, (list, tuple)) else [obj]


def create_folders(folders, create_deep=False):
    maker = os.makedirs if create_deep else os.mkdir
    for f in ensure_list_or_tuple(folders):
        if f is not None and not os.path.exists(f):
            maker(f)


_EPOCH_RE = re.compile(r"@epoch_(\d+)")
_VAL_DICE_RE = re.compile(r"val_dice_([\d.]+)\.")
_VAL_LOSS_RE = re.compile(r"val_loss_([\d.]+)\.")


def get_best_model(model_dir):
    """The best checkpoint file of a model folder, by pattern priority:
    val_dice (max) > val_loss (min) > any '@epoch' file (max epoch) >
    the last .npz by name."""
    model_dir = Path(model_dir)
    files = sorted(str(p) for p in model_dir.glob("*.npz"))
    if not files:
        raise OSError(f"No model files found in {model_dir}")
    dice_files = [(float(m.group(1)), f) for f in files
                  for m in [_VAL_DICE_RE.search(os.path.basename(f))] if m]
    if dice_files:
        return max(dice_files)[1]
    loss_files = [(float(m.group(1)), f) for f in files
                  for m in [_VAL_LOSS_RE.search(os.path.basename(f))] if m]
    if loss_files:
        return min(loss_files)[1]
    epoch_files = [(int(m.group(1)), f) for f in files
                   for m in [_EPOCH_RE.search(os.path.basename(f))] if m]
    if epoch_files:
        return max(epoch_files)[1]
    return files[-1]


def await_PIDs(pids, check_every=120, logger=None):
    """Block until the given PIDs (a list, or a comma-separated string) no
    longer exist."""
    if isinstance(pids, str):
        pids = [int(p) for p in pids.split(",")]
    pids = [int(p) for p in ensure_list_or_tuple(pids)]
    log = logger or print
    while pids:
        alive = []
        for pid in pids:
            try:
                os.kill(pid, 0)
            except OSError:
                continue
            alive.append(pid)
        if not alive:
            return
        log(f"Waiting for PIDs {alive} to terminate...")
        pids = alive
        time.sleep(check_every)
