"""`mp export_weights`: write a checkpoint as a reference (Keras) .h5 file.

Port of `multiplanarunet_tpu/bin/export_weights.py`: the same layer
names, creation order, attrs and weight_names, without flax. h5py is
imported when the script runs; without it the script raises an
ImportError that names h5py.

The inverse of `mp convert_weights`: takes this framework's .npz by-name
checkpoint (models/checkpoint.py) and emits an .h5 in the legacy Keras
`save_weights` layout that the reference's models load directly
(`tf.keras.Model.load_weights`, by name or by topology) — so a user can
take a model trained here back to perslev/MultiPlanarUNet.

Layer naming matches what the reference's model constructors produce
(`mpunet/models/unet.py:114-211` named layers for the 2D UNet;
`mpunet/models/unet3D.py` creates layers UNNAMED, so Keras auto-names them
conv3d[_N] / batch_normalization[_N] in creation order). The model family
is inferred from the conv kernel rank (4 = 2D, 5 = 3D).

Requires h5py only — no TensorFlow needed to write the file."""

from __future__ import annotations

import re
from argparse import ArgumentParser
from pathlib import Path

import numpy as np


def get_argparser():
    parser = ArgumentParser(
        description="Export a .npz checkpoint to a reference-compatible "
                    "Keras .h5 weight file"
    )
    parser.add_argument("--weights", type=str, required=True,
                        help="Path to the .npz checkpoint")
    parser.add_argument("--out", type=str, default="",
                        help="Output .h5 path (default: alongside the npz)")
    return parser


# our module path -> reference layer name (2D, named layers)
def _ref_layer_name_2d(module):
    m = re.match(r"^encoder_L(\d+)/conv([12])$", module)
    if m:
        return f"encoder_L{m.group(1)}_conv{m.group(2)}"
    m = re.match(r"^encoder_L(\d+)/bn$", module)
    if m:
        return f"encoder_L{m.group(1)}_BN"
    m = re.match(r"^bottom/conv([12])$", module)
    if m:
        return f"bottom_conv{m.group(1)}"
    if module == "bottom/bn":
        return "bottom_BN"
    m = re.match(r"^decoder_L(\d+)_conv_up$", module)
    if m:
        return f"upsample_L{m.group(1)}_conv1"
    m = re.match(r"^decoder_L(\d+)_bn_up$", module)
    if m:
        return f"upsample_L{m.group(1)}_BN1"
    m = re.match(r"^decoder_L(\d+)/conv([12])$", module)
    if m:
        return f"upsample_L{m.group(1)}_conv{int(m.group(2)) + 1}"
    m = re.match(r"^decoder_L(\d+)/bn$", module)
    if m:
        return f"upsample_L{m.group(1)}_BN2"
    if module == "out_conv":
        return "conv2d"
    return None


def _creation_order(depth):
    """Module paths in the reference's layer-creation order (shared by the
    2D and 3D constructors; convert_weights._ordered_targets is the
    inverse)."""
    order = []
    for i in range(depth):
        order += [f"encoder_L{i}/conv1", f"encoder_L{i}/conv2",
                  f"encoder_L{i}/bn"]
    order += ["bottom/conv1", "bottom/conv2", "bottom/bn"]
    for i in range(depth):
        order += [f"decoder_L{i}_conv_up", f"decoder_L{i}_bn_up",
                  f"decoder_L{i}/conv1", f"decoder_L{i}/conv2",
                  f"decoder_L{i}/bn"]
    order.append("out_conv")
    return order


def _infer_depth(modules):
    encs = {int(m.group(1)) for mod in modules
            if (m := re.match(r"^encoder_L(\d+)/", mod))}
    if not encs:
        raise ValueError("No encoder_L* modules found — not a UNet-family "
                         "checkpoint?")
    return max(encs) + 1


def export_h5(params, batch_stats, out_path, logger=print):
    """Write (params, batch_stats) trees to a legacy-Keras .h5 file.

    Returns the list of exported reference layer names."""
    from multiplanarunet_tpu_torch.bin.convert_weights import require_h5py
    from multiplanarunet_tpu_torch.models.checkpoint import flatten

    h5py = require_h5py()
    p_flat = flatten(params)
    bs_flat = flatten(batch_stats or {})
    modules = sorted({k.rsplit("/", 1)[0] for k in p_flat})
    depth = _infer_depth(modules)
    order = [m for m in _creation_order(depth) if m in modules]
    missing = [m for m in _creation_order(depth) if m not in modules]
    if missing:
        logger(f"[warn] modules missing from checkpoint: {missing}")

    # 2D vs 3D from the first conv kernel rank
    rank = p_flat[f"encoder_L0/conv1/kernel"].ndim
    is_3d = rank == 5
    conv_prefix = "conv3d" if is_3d else "conv2d"

    # reference layer names, in creation order
    names = []
    conv_n = bn_n = 0
    for module in order:
        if is_3d:
            if module.endswith("/bn") or module.endswith("_bn_up"):
                names.append("batch_normalization"
                             + (f"_{bn_n}" if bn_n else ""))
                bn_n += 1
            else:
                names.append(conv_prefix + (f"_{conv_n}" if conv_n else ""))
                conv_n += 1
        else:
            name = _ref_layer_name_2d(module)
            if name is None:
                logger(f"[skip] unmapped module '{module}'")
                continue
            names.append(name)

    # keras weight order per layer: conv = kernel, bias;
    # BN = gamma, beta, moving_mean, moving_variance
    def layer_weights(module):
        if module.endswith("/bn") or module.endswith("_bn_up"):
            return [
                ("gamma", p_flat[f"{module}/scale"]),
                ("beta", p_flat[f"{module}/bias"]),
                ("moving_mean", bs_flat[f"{module}/mean"]),
                ("moving_variance", bs_flat[f"{module}/var"]),
            ]
        return [("kernel", p_flat[f"{module}/kernel"]),
                ("bias", p_flat[f"{module}/bias"])]

    out_path = Path(out_path)
    with h5py.File(out_path, "w") as f:
        f.attrs["layer_names"] = [n.encode() for n in names]
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.3.0"
        for module, name in zip(order, names):
            grp = f.create_group(name)
            weights = layer_weights(module)
            grp.attrs["weight_names"] = [
                f"{name}/{leaf}:0".encode() for leaf, _ in weights
            ]
            for leaf, arr in weights:
                grp.create_dataset(f"{name}/{leaf}:0",
                                   data=np.asarray(arr, np.float32))
            shapes = " ".join(f"{leaf}{tuple(np.shape(a))}"
                              for leaf, a in weights)
            logger(f"  {module} -> {name}: {shapes}")
    return names


def entry_func(args=None):
    from multiplanarunet_tpu_torch.models import checkpoint as ckpt

    args = get_argparser().parse_args(args)
    npz = Path(args.weights)
    out = Path(args.out) if args.out else npz.with_suffix(".h5")
    params, batch_stats, _ = ckpt.load_weights(npz)
    names = export_h5(params, batch_stats, out)
    print(f"Wrote {len(names)} layers to {out}")
    print("Load it in the reference with model.load_weights(path) "
          "(by_name=True for the 2D UNet).")


if __name__ == "__main__":
    entry_func()
