"""Fused multi-view prediction as the upstream method defines it
(MultiPlanarUNet `mpunet/predict` with `sample_random_views_with_angle_
restriction` views and the learned fusion), written plainly:

for each view (u, v, n) = `plane_basis(view)`: planes at the offsets of
`n_planes` along n, each a dim x dim grid u * g[a] + v * g[b] (g =
linspace(-span // 2, span // 2, dim)) in scanner space, sampled
trilinearly from the volume (voxel i at A (i - (shape - 1) / 2), A the
affine's 3x3 block; outside the volume the background value); the
U-Net's class probabilities of every plane; each voxel's plane
coordinates basis^-1 A (i - c) read trilinearly from the stack of
probabilities (outside the stack the one-hot background); the fused
score sum_v W[v] * p_v + b. The argmax of the score is the class map.

The program's stack resample is a six-pass Catmull-Rom shear and its
remap six linear shear passes; the upstream method samples trilinearly
at the exact positions, which this reference follows. Everything is
float32 (TF32 off) unless `quant` asks for the control's precision.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import unet


def _rotation(axis, angle_deg):
    axis = np.asarray(axis, np.float64).ravel()
    axis = axis / np.linalg.norm(axis)
    half = np.deg2rad(angle_deg) / 2.0
    a = np.cos(half)
    b, c, d = -axis * np.sin(half)
    return np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c + a * d),
         2 * (b * d - a * c)],
        [2 * (b * c - a * d), a * a + c * c - b * b - d * d,
         2 * (c * d + a * b)],
        [2 * (b * d + a * c), 2 * (c * d - a * b),
         a * a + d * d - b * b - c * c]])


def plane_basis(view):
    """The upstream in-plane basis (u, v, n) of a view vector, as a 3x3
    matrix of columns (mpunet's `get_plane_basis` conventions)."""
    n = np.asarray(view, np.float64).copy()
    n /= np.linalg.norm(n)
    if np.all(n[:-1] < 0.2):
        n[:-1] = np.abs(n[:-1])
    if np.all(np.isclose(n[:-1], 0)):
        u, v = np.array([1.0, 0, 0]), np.array([0, 1.0, 0])
    else:
        nv = n.copy()
        nv[-1] += 1
        nv /= np.linalg.norm(nv)
        u = _rotation(np.cross(n, nv), -90).dot(n)
        v = np.cross(n, u)
    return np.column_stack((u, v, n))


def plane_offsets(n_planes, span, dim):
    """Offsets of a view's planes: 'same+N' gives dim + N planes over the
    span widened by N sample steps."""
    res = span / (dim - 1)
    extra = int(str(n_planes).split("+")[-1]) if "+" in str(n_planes) else 0
    n = dim + extra
    bound = (span + extra * res) / 2
    return np.linspace(-bound, bound, n)


def _sample(values, idx, fill):
    """values (C, D0, D1, D2) read trilinearly at fractional indices idx
    (..., 3) float64; `fill` (C,) where an index lies outside [0, n-1]."""
    sizes = torch.tensor(values.shape[1:], dtype=torch.float64,
                         device=idx.device)
    inside = ((idx >= 0) & (idx <= sizes - 1)).all(dim=-1)
    norm = (idx / (sizes - 1) * 2 - 1).to(torch.float32)
    grid = norm.flip(-1).reshape(1, -1, 1, 1, 3)
    out = F.grid_sample(values[None], grid, mode="bilinear",
                        padding_mode="border", align_corners=True)
    out = out.reshape(values.shape[0], *idx.shape[:-1]).movedim(0, -1)
    fill = torch.as_tensor(fill, dtype=out.dtype, device=out.device)
    return torch.where(inside[..., None], out, fill)


def fused_scores(*args, **kwargs):
    """The fused scores (X, Y, Z, n_classes) float32 of one volume (see
    `_fused_scores`), in the reference's float32 mode."""
    with unet.float32_mode():
        return _fused_scores(*args, **kwargs)


@torch.no_grad()
def _fused_scores(volume, affine, views, W, b, variables, depth, dim, span,
                 n_planes, bg_value, device, quant=None, chunk=12,
                 x_slab=16):
    """The fused scores (X, Y, Z, n_classes) float32 on `device` of one
    volume (X, Y, Z, C) numpy."""
    vol = torch.as_tensor(np.asarray(volume, np.float32), device=device)
    shape = vol.shape[:3]
    C = vol.shape[3]
    vals = vol.permute(3, 0, 1, 2).contiguous()
    A = torch.as_tensor(np.asarray(affine, np.float64)[:3, :3],
                        device=device)
    A_inv = torch.linalg.inv(A)
    c = torch.tensor([(n - 1) / 2.0 for n in shape], dtype=torch.float64,
                     device=device)
    g = torch.as_tensor(np.linspace(-(span // 2), span // 2, dim),
                        device=device)
    offs = torch.as_tensor(plane_offsets(n_planes, span, dim), device=device)
    P = offs.shape[0]
    params, stats = variables["params"], variables["batch_stats"]
    nc = params["out_conv"]["bias"].shape[0]
    bg = np.full((C,), bg_value, np.float32)
    onehot = np.zeros((nc,), np.float32)
    onehot[0] = 1.0
    W = torch.as_tensor(np.asarray(W, np.float32), device=device)
    score = torch.zeros(tuple(shape) + (nc,), dtype=torch.float32,
                        device=device)
    for vi, view in enumerate(views):
        basis = torch.as_tensor(plane_basis(view), device=device)
        pred = torch.empty((nc, dim, dim, P), dtype=torch.float32,
                           device=device)
        for o0 in range(0, P, chunk):
            o = offs[o0:o0 + chunk]
            pts = (basis[:, 0] * g[:, None, None, None]
                   + basis[:, 1] * g[None, :, None, None]
                   + basis[:, 2] * o[None, None, :, None])
            idx = pts @ A_inv.T + c
            planes = _sample(vals, idx, bg)          # (dim, dim, p, C)
            x = planes.permute(2, 3, 0, 1).contiguous()
            probs = unet.forward(params, stats, x, depth, quant=quant)
            pred[:, :, :, o0:o0 + chunk] = probs.permute(1, 2, 3, 0)
        M = torch.linalg.inv(basis) @ A
        g0, gs = float(g[0]), float(g[1] - g[0])
        q0, qs = float(offs[0]), float(offs[1] - offs[0])
        lo = torch.tensor([g0, g0, q0], dtype=torch.float64, device=device)
        st = torch.tensor([gs, gs, qs], dtype=torch.float64, device=device)
        jj = torch.arange(shape[1], dtype=torch.float64, device=device)
        kk = torch.arange(shape[2], dtype=torch.float64, device=device)
        for x0 in range(0, shape[0], x_slab):
            ii = torch.arange(x0, min(x0 + x_slab, shape[0]),
                              dtype=torch.float64, device=device)
            vox = torch.stack(torch.meshgrid(ii, jj, kk, indexing="ij"), -1)
            q = (vox - c) @ M.T
            mapped = _sample(pred, (q - lo) / st, onehot)
            score[x0:x0 + len(ii)] += W[vi] * mapped
        del pred
    score += torch.as_tensor(np.asarray(b, np.float32).reshape(-1),
                             device=device)
    return score
