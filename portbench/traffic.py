"""The benchmark's inputs, made from the seed: structured volumes, the
views, the fusion weights and the U-Net weights.

One general generator reads each cell's traffic file
(`portbench/workloads/<cell>.json`); the program receives only what is
made here. The same seed gives the same inputs: every draw comes from
`derive(seed, tag, ...)`.
"""

from __future__ import annotations

import hashlib
from statistics import NormalDist
from itertools import combinations

import numpy as np
import torch
import torch.nn.functional as F


def derive(seed, *tags):
    """A 63-bit seed for one purpose, from the run's seed (any whole
    number) and tags."""
    text = "/".join(str(t) for t in (int(seed),) + tags).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed, *tags):
    """A torch.Generator on `device` seeded for one purpose."""
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


# ----------------------------------------------------------------- volumes
def band_bounds(n_classes):
    """Bounds that split a standard normal field into n_classes - 1
    equal-volume bands (labels 1 .. n_classes - 1)."""
    bands = n_classes - 1
    return [NormalDist().inv_cdf(k / bands) for k in range(1, bands)]


# Grid step of the random control points the smooth field interpolates
FIELD_STEP_MM = 12.0


def smooth_field(shape, spacing, gen, device):
    """A smooth random field over a (X, Y, Z) grid: standard normal
    control points every FIELD_STEP_MM millimetres, interpolated
    trilinearly (float32, standardised)."""
    shape = tuple(int(s) for s in shape)
    coarse = tuple(int(np.ceil(n * s / FIELD_STEP_MM)) + 2
                   for n, s in zip(shape, spacing))
    pts = torch.randn((1, 1) + coarse, generator=gen, device=device)
    field = F.interpolate(pts, size=shape, mode="trilinear",
                          align_corners=True)[0, 0]
    return (field - field.mean()) / field.std()


RADII = (0.42, 0.378, 0.336)


def ellipsoid_radius(shape, spacing, device):
    """Each voxel's radius in a centred ellipsoid with semi-axes RADII x
    the physical extent of each axis (1 on its surface)."""
    axes = []
    for n, s, r in zip(shape, spacing, RADII):
        x = (torch.arange(n, device=device, dtype=torch.float32)
             - (n - 1) / 2.0) * float(s)
        axes.append(x / (r * n * float(s)))
    return torch.sqrt(axes[0][:, None, None] ** 2 + axes[1][None, :, None]
                      ** 2 + axes[2][None, None, :] ** 2)


def ellipsoid_mask(shape, spacing, device):
    """Voxels inside the centred ellipsoid."""
    return ellipsoid_radius(shape, spacing, device) <= 1.0


def structured_subject(shape, spacing, seed, index, device, n_classes=7):
    """A scan-like training subject, as `chip_smoke.py:structured_subject`
    makes one: zero background around an ellipsoid that holds a smooth
    random field (intensity 100 + 40 * field, at least 1), and labels
    1 .. n_classes - 1 as equal-volume bands of that field inside it (0 outside). Returns
    ((X, Y, Z) float32, (X, Y, Z) uint8) tensors on `device`."""
    gen = generator(device, seed, "subject", index)
    field = smooth_field(shape, spacing, gen, device)
    fg = ellipsoid_mask(shape, spacing, device)
    bounds = torch.tensor(band_bounds(n_classes), device=device)
    vol = torch.where(fg, (100.0 + 40.0 * field).clamp_min(1.0), 0.0)
    lab = torch.where(fg, 1 + torch.bucketize(field, bounds), 0)
    return vol, lab.to(torch.uint8)


# Intensity of the predict volumes' background and of the fill outside
# them, in the scaled units a predictor sees (mp predict scales at load)
PREDICT_BG = -3.0


def predict_volume(shape, spacing, seed, index, device="cpu", edge_mm=0.0):
    """A predict volume in scaled units: the smooth field inside the
    ellipsoid, PREDICT_BG outside, with a logistic edge edge_mm wide
    between them (a step with edge_mm 0). (X, Y, Z, 1) float32 numpy."""
    gen = generator(device, seed, "volume", index)
    field = smooth_field(shape, spacing, gen, device)
    r = ellipsoid_radius(shape, spacing, device)
    if edge_mm > 0:
        semi = min(rr * n * s for rr, n, s in zip(RADII, shape, spacing))
        inside = torch.sigmoid((1.0 - r) * semi / float(edge_mm))
    else:
        inside = (r <= 1.0).float()
    vol = PREDICT_BG + inside * (field - PREDICT_BG)
    return vol[..., None].cpu().numpy()


def rotation(axis, angle_deg):
    """Rotation matrix about a unit axis (Rodrigues)."""
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    a = np.deg2rad(angle_deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K


def draw_volume(traffic, seed, index):
    """(protocol, affine) of window volume `index` (an int) or of another
    kind's (a tag): the protocols come in blocks that hold each of the
    cell's protocols once, in an order drawn from the seed, so that every
    seed sends the same mix; the affine is the protocol's spacing turned
    by an angle drawn up to rotation_max_deg about a random axis."""
    protocols = traffic["protocols"]
    n = len(protocols)
    if isinstance(index, int):
        block = np.random.default_rng(derive(seed, "block", index // n))
        proto = protocols[int(block.permutation(n)[index % n])]
    else:
        proto = protocols[0]
    rng = np.random.default_rng(derive(seed, "draw", index))
    axis = rng.normal(size=3)
    angle = float(rng.uniform(0.0, float(traffic["rotation_max_deg"])))
    affine = np.eye(4)
    affine[:3, :3] = rotation(axis, angle) @ np.diag(proto["spacing"])
    return proto, affine


# ------------------------------------------------------------------- views
def random_views(n_views, min_angle_deg, rng):
    """A copy of the upstream view sampler
    (`sample_random_views_with_angle_restriction`): unit vectors on the
    +z hemisphere, redrawn until every pair is more than min_angle_deg
    apart, the restriction relaxed by one degree per failed draw."""
    while True:
        dev = rng.normal(size=(n_views, 3))
        views = dev / np.linalg.norm(dev, axis=1, keepdims=True)
        views[:, -1] = np.abs(views[:, -1])
        ok = True
        for v1, v2 in combinations(views, 2):
            cos = np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2))
            if not np.rad2deg(np.arccos(np.clip(cos, -1, 1))) > min_angle_deg:
                ok = False
                break
        if ok:
            return views
        min_angle_deg -= 1


def fusion_weights(n_views, n_classes, seed):
    """Learned-fusion weights W (n_views, n_classes) and bias b (1,
    n_classes) made from the seed."""
    rng = np.random.default_rng(derive(seed, "fusion"))
    W = (1.0 + 0.1 * rng.standard_normal((n_views, n_classes)))
    b = 0.1 * rng.standard_normal((1, n_classes))
    return W.astype(np.float32), b.astype(np.float32)


# ----------------------------------------------------------------- weights
def unet_layout(build):
    """[(collection, path, shape)] of a U-Net's variables in flax's layout
    (conv kernels (*k, I, O)), in the order of the upstream topology."""
    ndim = 3 if build["model_class_name"] == "UNet3D" else 2
    depth = int(build["depth"])
    k = int(build.get("kernel_size", 3))
    cf = float(build["complexity_factor"]) ** 0.5
    nf = int(build.get("init_filters", 64))
    out = []

    def conv(path, kk, cin, cout):
        out.append(("params", path + ("kernel",), (kk,) * ndim + (cin, cout)))
        out.append(("params", path + ("bias",), (cout,)))

    def bn(path, c):
        out.append(("params", path + ("scale",), (c,)))
        out.append(("params", path + ("bias",), (c,)))
        out.append(("batch_stats", path + ("mean",), (c,)))
        out.append(("batch_stats", path + ("var",), (c,)))

    def block(name, cin, f):
        conv((name, "conv1"), k, cin, f)
        conv((name, "conv2"), k, f, f)
        bn((name, "bn"), f)

    cin, filters = int(build["n_channels"]), nf
    for i in range(depth):
        f = int(filters * cf)
        block(f"encoder_L{i}", cin, f)
        cin, filters = f, filters * 2
    f = int(filters * cf)
    block("bottom", cin, f)
    cin = f
    for i in range(depth):
        filters //= 2
        f = int(filters * cf)
        conv((f"decoder_L{i}_conv_up",), 2, cin, f)
        bn((f"decoder_L{i}_bn_up",), f)
        block(f"decoder_L{i}", 2 * f, f)
        cin = f
    conv(("out_conv",), 1, cin, int(build["n_classes"]))
    return out


def make_weights(build, seed, device):
    """{"params": ..., "batch_stats": ...} nested dicts of float32 tensors
    on `device`, made from the seed in two draws: conv kernels
    He-uniform (limit sqrt(6 / fan_in), so activations keep their scale
    through the ReLU stack as a trained model's do), conv biases uniform
    in +-0.05; BatchNorm scale 1, bias 0, mean 0, var 1."""
    layout = unet_layout(build)
    kernels = [(c, p, s) for c, p, s in layout if p[-1] == "kernel"]
    biases = [(c, p, s) for c, p, s in layout
              if p[-1] == "bias" and len(s) == 1 and
              (c, p[:-1] + ("kernel",)) in {(c2, p2) for c2, p2, _ in kernels}]
    gen = generator(device, seed, "weights")
    n_k = sum(int(np.prod(s)) for _, _, s in kernels)
    n_b = sum(int(np.prod(s)) for _, _, s in biases)
    flat_k = torch.rand(n_k, generator=gen, device=device) * 2.0 - 1.0
    flat_b = (torch.rand(n_b, generator=gen, device=device) * 2.0 - 1.0) * 0.05
    tree = {"params": {}, "batch_stats": {}}

    def put(coll, path, value):
        node = tree[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    at = 0
    for coll, path, shape in kernels:
        n = int(np.prod(shape))
        fan_in = int(np.prod(shape[:-1]))
        put(coll, path, flat_k[at:at + n].view(shape)
            * float(np.sqrt(6.0 / fan_in)))
        at += n
    at = 0
    for coll, path, shape in biases:
        put(coll, path, flat_b[at:at + shape[0]])
        at += shape[0]
    for coll, path, shape in layout:
        if path[-1] in ("scale", "var"):
            put(coll, path, torch.ones(shape, device=device))
        elif coll == "batch_stats" or (path[-1] == "bias"
                                       and (coll, path) not in
                                       {(c, p) for c, p, _ in biases}):
            put(coll, path, torch.zeros(shape, device=device))
    return tree


def calibrate_confidence(tree, build, seed, device, target, edge_mm):
    """Scale the out conv (kernel and bias) so that the U-Net's mean
    largest class probability over eight planes across a calibration
    volume made from the seed is `target`: random weights otherwise give
    each seed its own softmax temperature, from near-uniform to near
    one-hot outputs, and with it its own share of voxels near a tie."""
    from portbench.reference import unet

    dim = int(build["dim"])
    vol = torch.as_tensor(predict_volume([dim] * 3, [1.0] * 3, seed,
                                         "calibration", device, edge_mm),
                          device=device)[..., 0]
    zs = torch.linspace(dim // 4, 3 * dim // 4, 8).long().to(device)
    x = vol[:, :, zs].permute(2, 0, 1)[:, None].contiguous()
    # Without cuDNN's algorithm search, whose workspaces would set the
    # run's memory peak
    with unet.float32_mode(benchmark=False), torch.no_grad():
        z = unet.forward(tree["params"], tree["batch_stats"], x,
                         int(build["depth"]), logits=True)
    lo, hi = 1e-3, 1e3
    for _ in range(60):  # bisection on log scale; confidence rises with s
        mid = (lo * hi) ** 0.5
        conf = float(torch.softmax(mid * z, dim=1).amax(dim=1).mean())
        lo, hi = (mid, hi) if conf < target else (lo, mid)
    out = tree["params"]["out_conv"]
    out["kernel"].mul_(lo)
    out["bias"].mul_(lo)
    return lo

