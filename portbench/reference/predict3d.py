"""Box inference of `mp predict_3D` (iso_live_3d, the JAX package's
`pred_3D_iso`) written plainly: the minimal tiling of the image's
scanner space by isotropic boxes of real_box_dim, then `extra` random
boxes; every box sampled trilinearly in scanner space, run through the
upstream 3D U-Net (`portbench/reference/unet.py`), and its class
probabilities added onto the nearest voxel of each of its samples; the
argmax of the sums is the class map.

Tiling: per axis the sample space max(real extent, real_box_dim), n =
ceil(sample space / real_box_dim) corners evenly spaced from 0 to sample
space - real_box_dim, shifted by - sample space / 2 (scanner space is
centred on the volume). Random boxes, in order, each three uniform draws
of numpy's legacy stream seeded with the volume's box seed: corner[i] =
U(0, space[i] - real_box_dim) - space[i] / 2 with space = max(real
extent, 1.1 real_box_dim); no box rotation (`mp predict_3D` samples
without orientation noise). Voxel i lies at A (i - (shape - 1) / 2), as in
`portbench/reference/sampler.py`; outside [0, n - 1] the image reads the
background value and the sum takes nothing. Float32 (TF32 off) unless
`quant` asks for the control's precision.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import sampler, unet


def spacing_of(affine):
    return np.linalg.norm(np.asarray(affine, np.float64)[:3, :3], axis=0)


def base_corners(shape, affine, real_box_dim):
    real = np.asarray(shape[:3], np.float64) * spacing_of(affine)
    space = np.maximum(real, real_box_dim)
    n = np.ceil(space / real_box_dim).astype(int)
    axes = [np.linspace(0.0, space[i] - real_box_dim, n[i]) - space[i] / 2
            for i in range(3)]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=1)


def random_corners(shape, affine, real_box_dim, n, seed):
    real = np.asarray(shape[:3], np.float64) * spacing_of(affine)
    space = np.maximum(real, real_box_dim * 1.1)
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(int(n)):
        draw = np.array([rng.uniform(0, space[i] - real_box_dim)
                         for i in range(3)])
        out.append(draw - space / 2.0)
    return np.asarray(out).reshape(-1, 3)


def n_extra(extra, n_base):
    """Random boxes for mp predict_3D's --extra_boxes ('Nx': N x the base
    count, or a count)."""
    if isinstance(extra, str):
        return int(float(extra.rstrip("x")) * n_base)
    return int(extra)


def scores(*args, **kwargs):
    """The summed class probabilities (X, Y, Z, n_classes) float32 of one
    volume (see `_scores`), in the reference's float32 mode."""
    with unet.float32_mode(benchmark=False):
        return _scores(*args, **kwargs)


@torch.no_grad()
def _scores(volume, affine, variables, depth, dim, real_box_dim, extra,
            box_seed, bg_value, device, quant=None, chunk=16):
    """volume (X, Y, Z, 1) numpy in scaled units."""
    vol = torch.as_tensor(np.asarray(volume[..., 0], np.float64),
                          device=device)
    shape = tuple(vol.shape)
    corners = base_corners(shape, affine, real_box_dim)
    corners = np.concatenate([corners, random_corners(
        shape, affine, real_box_dim, n_extra(extra, len(corners)),
        box_seed)])
    params, stats = variables["params"], variables["batch_stats"]
    nc = params["out_conv"]["bias"].shape[0]
    out = torch.zeros(shape + (nc,), dtype=torch.float32, device=device)
    n = torch.tensor(shape, device=device)
    eye = np.eye(3)
    for s in range(0, len(corners), chunk):
        t = torch.stack([sampler.voxel_coords(
            sampler.box_points(c, eye, real_box_dim, dim, device), affine,
            shape) for c in corners[s:s + chunk]])
        x = sampler.read_linear(vol, t, float(bg_value)).float()[:, None]
        probs = unet.forward(params, stats, x, depth, quant=quant)
        idx = torch.round(t).long()
        inside = ((idx >= 0) & (idx < n)).all(dim=-1).reshape(-1)
        flat = ((idx[..., 0] * shape[1] + idx[..., 1]) * shape[2]
                + idx[..., 2]).reshape(-1)
        out.view(-1, nc).index_add_(
            0, flat[inside], probs.movedim(1, -1).reshape(-1, nc)[inside])
    return out
