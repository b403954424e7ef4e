"""Weight files in the JAX package's format, read and written with numpy.

The format is that of `multiplanarunet_tpu/models/checkpoint.py`: one
numpy .npz whose keys are "params/<module>/<leaf>" and
"batch_stats/<module>/<leaf>", with an optional "__meta__" entry holding
json bytes; <module> is a path of any depth (a MultiTaskUNet2D's tree
nests `encoder/encoder_L0/...` and `task_<name>/decoder_L0/...`).
`unet_state_dict_from_jax` carries such a tree onto a torch UNet, UNet3D
or MultiTaskUNet2D (conv kernels HWIO -> OIHW, DHWIO -> OIDHW; a torch
module path 'a.b.c' is the flax path a/b/c),
`unet_variables_from_model` is its inverse, `save_weights` writes a
tree, and `restore_by_name` overlays a file onto a model wherever names
and shapes match (the JAX package's by-name restore). Each package reads
the files the other writes.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch


def unflatten(entries):
    """{'a/b/leaf': array} -> the nested dict {'a': {'b': {'leaf':
    array}}}."""
    tree = {}
    for key, value in entries.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def flatten(tree, prefix=""):
    """The inverse of `unflatten`: a nested dict -> {'<prefix>/a/b/leaf':
    numpy array} (no prefix: 'a/b/leaf'), depth first in key order."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def save_weights(path, params, batch_stats=None, meta=None):
    """Write params (+ batch stats, + json metadata) to one .npz file,
    creating its folder."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    entries = flatten(params, "params")
    if batch_stats:
        entries.update(flatten(batch_stats, "batch_stats"))
    if meta is not None:
        entries["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                            dtype=np.uint8)
    np.savez(path, **entries)


def load_weights(path):
    """Read a weight file -> (params, batch_stats, meta) as nested dicts
    of numpy arrays (meta None when absent)."""
    with np.load(Path(path), allow_pickle=False) as data:
        entries = {k: data[k] for k in data.files}
    meta = None
    if "__meta__" in entries:
        meta = json.loads(entries.pop("__meta__").tobytes().decode())
    params = unflatten({k[len("params/"):]: v for k, v in entries.items()
                        if k.startswith("params/")})
    batch_stats = unflatten({k[len("batch_stats/"):]: v
                             for k, v in entries.items()
                             if k.startswith("batch_stats/")})
    return params, batch_stats, meta


# torch leaf -> (flax collection, flax leaf)
_CONV = {"weight": ("params", "kernel"), "bias": ("params", "bias")}
_BN = {"weight": ("params", "scale"), "bias": ("params", "bias"),
       "running_mean": ("batch_stats", "mean"),
       "running_var": ("batch_stats", "var")}


def _kernel_to_torch(arr):
    """A flax conv kernel (*spatial, I, O) as torch's (O, I, *spatial); any
    other array as it is (numpy arrays and tensors alike)."""
    if arr.ndim < 4:
        return arr
    n = arr.ndim
    order = (n - 1, n - 2) + tuple(range(n - 2))
    if isinstance(arr, torch.Tensor):
        return arr.permute(order)
    return arr.transpose(order)


def _kernel_to_flax(arr):
    """The inverse of `_kernel_to_torch`: (O, I, *spatial) -> (*spatial,
    I, O)."""
    if arr.ndim < 4:
        return arr
    return arr.transpose(tuple(range(2, arr.ndim)) + (1, 0))


def _flax_key(torch_key):
    """'encoder_L0.conv1.weight' -> ('params', ('encoder_L0', 'conv1',
    'kernel')), at any nesting ('task_t1.decoder_L0_bn_up.running_var' ->
    ('batch_stats', ('task_t1', 'decoder_L0_bn_up', 'var'))); None for
    buffers with no flax counterpart."""
    *mods, leaf = torch_key.split(".")
    if leaf == "num_batches_tracked":
        return None
    table = _BN if (mods[-1] == "bn" or mods[-1].endswith("_bn_up")) else _CONV
    coll, flax_leaf = table[leaf]
    return coll, tuple(mods) + (flax_leaf,)


def flax_variables(model):
    """[(collection, flax path, flax shape)] of every entry of `model`'s
    state that has a flax counterpart, in state-dict order: conv kernels
    in flax's (*spatial, I, O) order, the rest as torch holds them."""
    out = []
    for key, ref in model.state_dict().items():
        flax = _flax_key(key)
        if flax is not None:
            shape = tuple(ref.shape)
            if len(shape) >= 4:
                shape = shape[2:] + (shape[1], shape[0])
            out.append(flax + (shape,))
    return out


def unet_state_dict_from_jax(params, batch_stats, model):
    """Map a flax UNet, UNet3D or MultiTaskUNet2D variable tree onto
    `model`'s state dict. The tree's leaves are numpy arrays (the state
    is then on the host) or tensors (the state stays on their device).

    Conv kernels go HWIO -> OIHW (DHWIO -> OIDHW in 3D); BatchNorm
    scale/bias/mean/var go to weight/bias/running_mean/running_var.
    Raises KeyError on a key the model needs that the tree lacks or on a
    tree entry the model has no place for, and ValueError on a shape
    mismatch."""
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
        if isinstance(node, torch.Tensor):
            arr = _kernel_to_torch(node.float())
        else:
            arr = _kernel_to_torch(np.asarray(node, np.float32))
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{coll}/{'/'.join(path)} has shape "
                             f"{tuple(arr.shape)} (as {key}); the model "
                             f"needs {tuple(ref.shape)}")
        state[key] = (arr.contiguous() if isinstance(arr, torch.Tensor)
                      else torch.from_numpy(np.array(arr)))
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


def _to_flax_array(tensor):
    arr = tensor.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(_kernel_to_flax(arr))


def unet_variables_from_model(model):
    """The inverse of `unet_state_dict_from_jax`: `model`'s state as the
    flax (params, batch_stats) trees of numpy float32 arrays (conv kernels
    OIHW -> HWIO, OIDHW -> DHWIO; BatchNorm weight/bias/running_mean/
    running_var -> scale/bias/mean/var)."""
    trees = {"params": {}, "batch_stats": {}}
    for key, value in model.state_dict().items():
        flax = _flax_key(key)
        if flax is None:
            continue
        coll, path = flax
        node = trees[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _to_flax_array(value)
    return trees["params"], trees["batch_stats"]


def save_unet_weights(path, model, meta=None):
    """Write `model`'s weights as a JAX-format .npz file."""
    params, batch_stats = unet_variables_from_model(model)
    save_weights(path, params, batch_stats, meta=meta)


def restore_by_name(model, params, batch_stats=None, logger=None):
    """Overlay a flax (params, batch_stats) tree onto `model` wherever the
    names and shapes match, warning for every other entry of the tree
    (the JAX package's by-name restore). Returns the number of parameter
    arrays restored."""
    current = {}
    for key, ref in model.state_dict().items():
        flax = _flax_key(key)
        if flax is not None:
            current[(flax[0],) + flax[1]] = (key, ref)
    state = model.state_dict()
    restored = 0
    trees = {"params": params, "batch_stats": batch_stats or {}}
    for coll, tree in trees.items():
        for path in _leaf_paths(tree):
            node = tree
            for p in path:
                node = node[p]
            arr = _kernel_to_torch(np.asarray(node, np.float32))
            target = current.get((coll,) + path)
            if target is None or tuple(target[1].shape) != arr.shape:
                if logger is not None:
                    logger.warn(f"Checkpoint key '{coll}/{'/'.join(path)}' "
                                f"not restored (missing or shape mismatch)")
                continue
            state[target[0]] = torch.from_numpy(np.array(arr))
            restored += coll == "params"
    model.load_state_dict(state)
    return restored
