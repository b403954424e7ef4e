"""`mp convert_weights`: import a reference (mpunet/Keras) .h5 checkpoint.

Port of `multiplanarunet_tpu/bin/convert_weights.py` (the same layer-name
mapping, the same .npz keys), written through the port's
`models/checkpoint.py` without flax. h5py is imported when the script
runs; without it the script raises an ImportError that names h5py.

Lets users of perslev/MultiPlanarUNet bring their trained models here
without retraining: reads the Keras weight files the reference writes
(`model.save_weights(...)/ModelCheckPointClean`, weights-only h5; full
`model.save` h5 is handled via its `model_weights/` group) and writes this
framework's .npz by-name checkpoint (models/checkpoint.py).

Layer-name mapping (reference `mpunet/models/unet.py:115-211`):

  encoder_L{i}_conv1/2        -> params/encoder_L{i}/conv1|conv2
  encoder_L{i}_BN             -> encoder_L{i}/bn (+ batch_stats)
  bottom_conv1/2, bottom_BN   -> bottom/...
  upsample_L{i}_conv1 (2x2)   -> decoder_L{i}_conv_up
  upsample_L{i}_BN1           -> decoder_L{i}_bn_up
  upsample_L{i}_conv2/3       -> decoder_L{i}/conv1|conv2
  upsample_L{i}_BN2           -> decoder_L{i}/bn
  conv2d[_N] (unnamed out)    -> out_conv

The reference's 3D model (`mpunet/models/unet3D.py`) creates all layers
UNNAMED, so Keras auto-names them conv3d[_N] / batch_normalization[_N] in
creation order; for such files the mapping is reconstructed from that
order (encoder convs, bottom, then per-decoder-level up-conv + two convs,
then the output conv). Keras stores conv kernels HWIO / DHWIO and BN as
gamma/beta/moving_mean/moving_variance — identical layouts to flax, so the
arrays copy through unchanged.
"""

from __future__ import annotations

import re
from argparse import ArgumentParser
from pathlib import Path

import numpy as np


def require_h5py():
    """The h5py module, or an ImportError that names it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"mp convert_weights and mp export_weights need h5py to read "
            f"and write Keras .h5 files ({e})") from e
    return h5py


def get_argparser():
    parser = ArgumentParser(
        description="Convert a reference (Keras .h5) checkpoint to this "
                    "framework's .npz weight format"
    )
    parser.add_argument("--h5", type=str, required=True,
                        help="Path to the reference model_weights.h5 (or a "
                             "full Keras model save)")
    parser.add_argument("--out", type=str, default="",
                        help="Output .npz path (default: alongside the h5)")
    return parser


def _read_keras_h5(path):
    """-> {layer_name: {weight_leaf: array}} in the file's storage order.

    Handles both `save_weights` files (layers at top level) and full
    `model.save` files (under 'model_weights'). Weight leaves are the
    basenames with ':0' stripped (kernel, bias, gamma, beta, moving_mean,
    moving_variance)."""
    h5py = require_h5py()

    layers = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        names = [n.decode() if isinstance(n, bytes) else n
                 for n in root.attrs.get("layer_names", list(root.keys()))]
        for name in names:
            if name not in root:
                continue
            grp = root[name]
            weights = {}

            def visit(key, obj, weights=weights):
                if hasattr(obj, "shape") and obj.shape is not None:
                    leaf = key.split("/")[-1].split(":")[0]
                    weights[leaf] = np.asarray(obj)

            grp.visititems(visit)
            if weights:
                layers[name] = weights
    return layers


_NAMED_2D = [
    (re.compile(r"^encoder_L(\d+)_conv([12])$"),
     lambda m: f"encoder_L{m.group(1)}/conv{m.group(2)}"),
    (re.compile(r"^encoder_L(\d+)_BN$"),
     lambda m: f"encoder_L{m.group(1)}/bn"),
    (re.compile(r"^bottom_conv([12])$"),
     lambda m: f"bottom/conv{m.group(1)}"),
    (re.compile(r"^bottom_BN$"), lambda m: "bottom/bn"),
    (re.compile(r"^upsample_L(\d+)_conv1$"),
     lambda m: f"decoder_L{m.group(1)}_conv_up"),
    (re.compile(r"^upsample_L(\d+)_BN1$"),
     lambda m: f"decoder_L{m.group(1)}_bn_up"),
    (re.compile(r"^upsample_L(\d+)_conv([23])$"),
     lambda m: f"decoder_L{m.group(1)}/conv{int(m.group(2)) - 1}"),
    (re.compile(r"^upsample_L(\d+)_BN2$"),
     lambda m: f"decoder_L{m.group(1)}/bn"),
    (re.compile(r"^conv2d(_\d+)?$"), lambda m: "out_conv"),
]


def _auto_index(name):
    """Keras auto-name suffix as a sort key: conv3d -> 0, conv3d_7 -> 7."""
    m = re.search(r"_(\d+)$", name)
    return int(m.group(1)) if m else 0


def _ordered_targets(n_convs, n_bns):
    """Target module paths for UNNAMED (auto-named) reference models, in
    Keras layer-creation order. Solves depth from the layer counts:
    convs = 2*depth (enc) + 2 (bottom) + 3*depth (dec) + 1 (out)."""
    depth, rem = divmod(n_convs - 3, 5)
    if rem or depth < 1 or n_bns != 2 * depth + depth + 1:
        raise ValueError(
            f"Cannot solve a UNet depth from {n_convs} conv and {n_bns} BN "
            f"layers — not an unmodified reference UNet/UNet3D save?"
        )
    convs, bns = [], []
    for i in range(depth):
        convs += [f"encoder_L{i}/conv1", f"encoder_L{i}/conv2"]
        bns.append(f"encoder_L{i}/bn")
    convs += ["bottom/conv1", "bottom/conv2"]
    bns.append("bottom/bn")
    for i in range(depth):
        convs += [f"decoder_L{i}_conv_up", f"decoder_L{i}/conv1",
                  f"decoder_L{i}/conv2"]
        bns += [f"decoder_L{i}_bn_up", f"decoder_L{i}/bn"]
    convs.append("out_conv")
    return convs, bns


def map_layers(layers, logger=print):
    """{h5 layer name: weights} -> (params_entries, batch_stats_entries)
    keyed by 'module/leaf' paths of this framework's models."""
    named = any(re.match(r"^encoder_L\d+_conv1$", n) for n in layers)
    mapping = {}
    if named:
        for name in layers:
            for pat, to in _NAMED_2D:
                m = pat.match(name)
                if m:
                    mapping[name] = to(m)
                    break
            else:
                logger(f"[skip] unrecognized layer '{name}'")
    else:
        conv_names = sorted((n for n in layers if n.startswith("conv")),
                            key=_auto_index)
        bn_names = sorted(
            (n for n in layers if n.startswith("batch_normalization")),
            key=_auto_index)
        conv_to, bn_to = _ordered_targets(len(conv_names), len(bn_names))
        mapping.update(zip(conv_names, conv_to))
        mapping.update(zip(bn_names, bn_to))

    params, batch_stats = {}, {}
    leaf_map = {"kernel": ("params", "kernel"), "bias": ("params", "bias"),
                "gamma": ("params", "scale"), "beta": ("params", "bias"),
                "moving_mean": ("batch_stats", "mean"),
                "moving_variance": ("batch_stats", "var")}
    for name, target in mapping.items():
        shapes = []
        for leaf, arr in layers[name].items():
            if leaf not in leaf_map:
                logger(f"[skip] {name}/{leaf}: unknown weight kind")
                continue
            coll, our_leaf = leaf_map[leaf]
            (params if coll == "params" else batch_stats)[
                f"{target}/{our_leaf}"] = arr
            shapes.append(f"{our_leaf}{tuple(arr.shape)}")
        # Per-layer shape trace: conversion is by NAME only, so a
        # checkpoint from a different depth/filters model maps cleanly and
        # only surfaces at restore time (restore_by_name warns and skips
        # shape-mismatched keys) — this log is the converter-side evidence.
        logger(f"  {name} -> {target}: {' '.join(shapes)}")
    return params, batch_stats


def entry_func(args=None):
    from multiplanarunet_tpu_torch.models import checkpoint as ckpt

    args = get_argparser().parse_args(args)
    h5_path = Path(args.h5)
    out = Path(args.out) if args.out else h5_path.with_suffix(".npz")

    layers = _read_keras_h5(h5_path)
    print(f"Read {len(layers)} layers from {h5_path}")
    params, batch_stats = map_layers(layers)
    ckpt.save_weights(out, ckpt.unflatten(params),
                      ckpt.unflatten(batch_stats),
                      meta={"converted_from": str(h5_path)})
    print(f"Wrote {len(params)} param + {len(batch_stats)} batch-stat "
          f"arrays to {out}")
    print("Use it via 'mp train --initialize_from <npz>' or by placing it "
          "in <project>/model/. Array shapes are validated when the "
          "checkpoint is loaded against a model (mismatches are skipped "
          "with a warning).")


if __name__ == "__main__":
    entry_func()
