"""Read the JAX package's weight files and carry them onto the torch UNet.

The format is that of `multiplanarunet_tpu/models/checkpoint.py`: one
numpy .npz whose keys are "params/<module>/<leaf>" and
"batch_stats/<module>/<leaf>", with an optional "__meta__" entry holding
json bytes. It is read with numpy alone.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch


def _unflatten(entries):
    tree = {}
    for key, value in entries.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def load_weights(path):
    """Read a weight file -> (params, batch_stats, meta) as nested dicts
    of numpy arrays (meta None when absent)."""
    with np.load(Path(path), allow_pickle=False) as data:
        entries = {k: data[k] for k in data.files}
    meta = None
    if "__meta__" in entries:
        meta = json.loads(entries.pop("__meta__").tobytes().decode())
    params = _unflatten({k[len("params/"):]: v for k, v in entries.items()
                         if k.startswith("params/")})
    batch_stats = _unflatten({k[len("batch_stats/"):]: v
                              for k, v in entries.items()
                              if k.startswith("batch_stats/")})
    return params, batch_stats, meta


# torch leaf -> (flax collection, flax leaf)
_CONV = {"weight": ("params", "kernel"), "bias": ("params", "bias")}
_BN = {"weight": ("params", "scale"), "bias": ("params", "bias"),
       "running_mean": ("batch_stats", "mean"),
       "running_var": ("batch_stats", "var")}


def _flax_key(torch_key):
    """'encoder_L0.conv1.weight' -> ('params', ('encoder_L0', 'conv1',
    'kernel')); None for buffers with no flax counterpart."""
    *mods, leaf = torch_key.split(".")
    if leaf == "num_batches_tracked":
        return None
    table = _BN if (mods[-1] == "bn" or mods[-1].endswith("_bn_up")) else _CONV
    coll, flax_leaf = table[leaf]
    return coll, tuple(mods) + (flax_leaf,)


def unet_state_dict_from_jax(params, batch_stats, model):
    """Map a flax UNet variable tree onto `model`'s state dict.

    Conv kernels go HWIO -> OIHW; BatchNorm scale/bias/mean/var go to
    weight/bias/running_mean/running_var. Raises KeyError on a key the
    model needs that the tree lacks or on a tree entry the model has no
    place for, and ValueError on a shape mismatch."""
    trees = {"params": params, "batch_stats": batch_stats or {}}
    used = set()
    state = {}
    for key, ref in model.state_dict().items():
        flax = _flax_key(key)
        if flax is None:
            state[key] = torch.zeros_like(ref)
            continue
        coll, path = flax
        node = trees[coll]
        for p in path:
            if not isinstance(node, dict) or p not in node:
                raise KeyError(f"{coll}/{'/'.join(path)} missing (needed "
                               f"for {key})")
            node = node[p]
        arr = np.asarray(node, np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{coll}/{'/'.join(path)} has shape "
                             f"{tuple(arr.shape)} (as {key}); the model "
                             f"needs {tuple(ref.shape)}")
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
        used.add((coll,) + path)
    for coll, tree in trees.items():
        for path in _leaf_paths(tree):
            if (coll,) + path not in used:
                raise KeyError(f"{coll}/{'/'.join(path)} has no place in "
                               f"the model")
    return state


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)
