"""The training sampler written plainly: where a batch's planes or boxes
lie in a subject, the scaler and fill, and the Elastic deformation.

Scaler: RobustScaler over all voxels (centre the median, divide by the
25-75 percentile range, 1 where that range is 0), the fill outside the
volume its 1st percentile ('1pct'), scaled likewise. Voxel i of a
subject lies at A (i - (shape - 1) / 2) in scanner space, A the
affine's 3x3 block, as in `portbench/reference/predict.py`.

Positions: a plane is the dim x dim grid u * g[a] + v * g[b] + n * offset
(g = linspace(-span // 2, span // 2, dim)) of its basis's columns (u, v,
n); a box is the grid of linspace(corner, corner + real_box_dim, dim) on
each axis, turned by its rotation R about its centre c: c + R (p - c).
Images are read trilinearly, labels by the nearest voxel (a fraction of
one half goes to the lower voxel), the fill (labels: 0) outside [0, n -
1] on any axis.

Elastic (the configuration's Elastic2D / Elastic3D, as the JAX package
defines them and the port reproduces them): per batch the augmenter's
numpy RandomState draws the apply mask (rand(B) <= apply_prob), then the
alphas, then the sigmas; one uniform [-1, 1) noise field per sample and
axis, blurred by a gaussian of the sample's sigma (taps to int(4 sigma +
0.5), at most RADIUS of the rank, normalised; zero outside the field),
times alpha, is the displacement along that axis; the image is read
linearly at grid + displacement (the fill outside), the labels by the
nearest pixel (0 outside); samples whose mask is off pass unchanged. The
upstream method blurs with scipy's gaussian_filter, whose taps reach 4
sigma: the cut at RADIUS is the JAX package's and the port's. Float64
throughout.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# The gaussian's widest radius in pixels, by spatial rank
RADIUS = {2: 64, 3: 52}


# ------------------------------------------------------------------ scaler
def _percentile(sorted_flat, q):
    """numpy's linear percentile q of a sorted 1-D float64 tensor."""
    pos = q / 100.0 * (sorted_flat.numel() - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, sorted_flat.numel() - 1)
    frac = pos - lo
    return float(sorted_flat[lo] + (sorted_flat[hi] - sorted_flat[lo])
                 * frac)


@torch.no_grad()
def robust_scaled(volume):
    """(scaled volume float64, scaled fill) of one channel (X, Y, Z)."""
    s = volume.double().flatten().sort().values
    med = _percentile(s, 50.0)
    iqr = _percentile(s, 75.0) - _percentile(s, 25.0)
    scale = iqr if iqr != 0.0 else 1.0
    fill = (_percentile(s, 1.0) - med) / scale
    del s
    return (volume.double() - med) / scale, fill


# ---------------------------------------------------------------- sampling
def voxel_coords(points, affine, shape):
    """Fractional voxel indices (..., 3) of scanner points (..., 3)."""
    A = torch.as_tensor(np.asarray(affine, np.float64)[:3, :3],
                        device=points.device)
    c = torch.tensor([(n - 1) / 2.0 for n in shape], dtype=torch.float64,
                     device=points.device)
    return points @ torch.linalg.inv(A).T + c


def _cells(t, shape):
    n = torch.tensor(shape, dtype=torch.float64, device=t.device)
    oob = ((t < 0) | (t > n - 1)).any(dim=-1)
    i0 = torch.minimum(torch.clamp(torch.floor(t), min=0.0), n - 2)
    return i0, t - i0, oob


def read_linear(volume, t, fill):
    """volume (X, Y, Z) read trilinearly at indices t (..., 3)."""
    i0, f, oob = _cells(t, volume.shape)
    i0 = i0.long()
    out = torch.zeros(t.shape[:-1], dtype=torch.float64, device=t.device)
    for d in np.ndindex(2, 2, 2):
        w = torch.ones_like(out)
        for a in range(3):
            w = w * (f[..., a] if d[a] else 1.0 - f[..., a])
        out += w * volume[i0[..., 0] + d[0], i0[..., 1] + d[1],
                          i0[..., 2] + d[2]].double()
    return torch.where(oob, torch.full_like(out, fill), out)


def read_nearest(volume, t, fill):
    """volume (X, Y, Z) read at the nearest voxel of indices t (..., 3)."""
    i0, f, oob = _cells(t, volume.shape)
    i = torch.where(f <= 0.5, i0, i0 + 1).long()
    out = volume[i[..., 0], i[..., 1], i[..., 2]].double()
    return torch.where(oob, torch.full_like(out, float(fill)), out)


def plane_points(basis, offset, span, dim, device):
    """(dim, dim, 3) scanner points of one plane."""
    b = torch.as_tensor(np.asarray(basis, np.float64), device=device)
    half = float(span // 2)
    g = torch.linspace(-half, half, int(dim), dtype=torch.float64,
                       device=device)
    return (g[:, None, None] * b[:, 0] + g[None, :, None] * b[:, 1]
            + float(offset) * b[:, 2])


def box_points(corner, rot, real_box_dim, dim, device):
    """(dim, dim, dim, 3) scanner points of one box."""
    corner = torch.as_tensor(np.asarray(corner, np.float64), device=device)
    R = torch.as_tensor(np.asarray(rot, np.float64), device=device)
    axes = [torch.linspace(float(corner[a]), float(corner[a])
                           + float(real_box_dim), int(dim),
                           dtype=torch.float64, device=device)
            for a in range(3)]
    p = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    c = corner + float(real_box_dim) / 2.0
    return (p - c) @ R.T + c


# ----------------------------------------------------------------- elastic
def elastic_draws(seed, count, batch, alpha, sigma, apply_prob):
    """(apply mask, alphas, sigmas) of the augmenter's batch `count`
    (1-based), its RandomState replayed from `seed` over the batches
    before."""
    rng = np.random.RandomState(seed)

    def draw(value):
        if isinstance(value, (list, tuple)):
            return rng.uniform(value[0], value[1], size=batch)
        return np.full(batch, float(value))

    for _ in range(int(count)):
        mask = rng.rand(batch) <= apply_prob
        alphas, sigmas = draw(alpha), draw(sigma)
    return mask, alphas, sigmas


def gaussian_blur(field, sigma, radius_max):
    """The separable gaussian blur of one field (*spatial) float64."""
    r = min(int(4.0 * sigma + 0.5), int(radius_max))
    x = torch.arange(-r, r + 1, dtype=torch.float64, device=field.device)
    w = torch.exp(-0.5 * (x / sigma) ** 2)
    w = (w / w.sum()).view(1, 1, -1)
    for axis in range(field.dim()):
        moved = field.movedim(axis, -1)
        shape = moved.shape
        rows = moved.reshape(-1, 1, shape[-1])
        field = F.conv1d(rows, w, padding=r).reshape(shape).movedim(-1, axis)
    return field


def _read_grid_linear(images, t, fill):
    """images (*spatial) read (bi/tri)linearly at pixel indices t
    (*spatial, rank), fill outside."""
    rank = images.dim()
    n = torch.tensor(images.shape, dtype=torch.float64, device=t.device)
    oob = ((t < 0) | (t > n - 1)).any(dim=-1)
    i0 = torch.minimum(torch.clamp(torch.floor(t), min=0.0), n - 2)
    f = t - i0
    i0 = i0.long()
    out = torch.zeros(t.shape[:-1], dtype=torch.float64, device=t.device)
    for d in np.ndindex(*(2,) * rank):
        w = torch.ones_like(out)
        for a in range(rank):
            w = w * (f[..., a] if d[a] else 1.0 - f[..., a])
        idx = tuple(i0[..., a] + d[a] for a in range(rank))
        out += w * images[idx].double()
    return torch.where(oob, torch.full_like(out, fill), out)


def _read_grid_nearest(labels, t):
    rank = labels.dim()
    n = torch.tensor(labels.shape, dtype=torch.float64, device=t.device)
    oob = ((t < 0) | (t > n - 1)).any(dim=-1)
    i0 = torch.minimum(torch.clamp(torch.floor(t), min=0.0), n - 2)
    i = torch.where(t - i0 <= 0.5, i0, i0 + 1).long()
    out = labels[tuple(i[..., a] for a in range(rank))].double()
    return torch.where(oob, torch.zeros_like(out), out)


@torch.no_grad()
def elastic(image, label, fields, alpha, sigma, fill):
    """One sample deformed: image and label (*spatial) float64, fields
    [one (*spatial) noise field per axis]."""
    rank = image.dim()
    grids = torch.meshgrid(*(torch.arange(n, dtype=torch.float64,
                                          device=image.device)
                             for n in image.shape), indexing="ij")
    t = torch.stack([g + alpha * gaussian_blur(f.double(), sigma,
                                               RADIUS[rank])
                     for g, f in zip(grids, fields)], dim=-1)
    return _read_grid_linear(image, t, fill), _read_grid_nearest(label, t)
