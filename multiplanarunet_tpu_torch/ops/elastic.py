"""Elastic deformation of batches of 2D slices or 3D boxes on the device,
in torch.

Port of `multiplanarunet_tpu/ops/elastic.py:elastic_deform_2d_batch` and
`elastic_deform_3d_batch` (Simard-style, as the reference's host-side
elastic augmentation):

- one uniform random field in [-1, 1) per sample and spatial axis (the
  displacement along that axis),
- each blurred by a separable gaussian with the sample's sigma: a static
  kernel radius (64 in 2D, 52 in 3D) whose weights come from the dynamic
  sigma, taps past scipy's truncation (4 sigma) set to 0, normalised,
  applied as a zero-padded 1-D convolution along each axis in turn
  (scipy's gaussian_filter with mode='constant'),
- scaled by the sample's alpha and added to the pixel grid,
- the image warped (bi/trilinear) with an out-of-bounds fill per channel,
  the labels by nearest neighbour (frac <= 0.5 picks the lower pixel)
  with class 0 out of bounds,
- samples whose apply flag is off passed through unchanged.

The 3D warp samples through the plain trilinear pool gather
(`ops.interp.grid_gather_pool`, one slot per sample), where the JAX
package uses its corner-packed gather: the same function up to the order
of the eight-corner sum.

`elastic_deform_{2d,3d}_fields` take the noise fields as arguments;
`elastic_deform_{2d,3d}_batch` draw them from a PRNG key as the JAX
functions do (`split(key)` or `split(key, 3)`, then `uniform(k, (B, d,
d[, d]), -1, 1)` per axis, through `ops.prng` on the images' device), so
the same key gives the JAX package's fields bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from multiplanarunet_tpu_torch.ops import prng
from multiplanarunet_tpu_torch.ops.interp import grid_gather_pool

# scipy's gaussian_filter truncates at 4 sigma by default
_TRUNCATE = 4.0


def gauss_kernels(sigmas, radius):
    """(B, 2*radius+1) normalised gaussian weights for per-sample sigmas,
    zero past _TRUNCATE * sigma + 0.5."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=sigmas.device)
    sigma = torch.clamp(sigmas.float(), min=1e-3)[:, None]
    w = torch.exp(-0.5 * (x[None] / sigma) ** 2)
    w = torch.where(x[None].abs() <= _TRUNCATE * sigma + 0.5, w,
                    torch.zeros_like(w))
    return w / w.sum(dim=1, keepdim=True)


def _blur_axis(fields, kernels, axis):
    """Zero-padded 1-D convolution of each field of `fields` (N, *spatial)
    with its own kernel (N, K), along spatial `axis`."""
    n, radius = fields.shape[0], kernels.shape[1] // 2
    moved = fields.movedim(axis + 1, -1)
    shape = moved.shape
    # (rows, N, length): the fields ride the channel axis, one group each
    rows = moved.reshape(n, -1, shape[-1]).transpose(0, 1)
    out = F.conv1d(rows, kernels[:, None, :], padding=radius, groups=n)
    return out.transpose(0, 1).reshape(shape).movedim(-1, axis + 1)


def smooth_fields(fields, sigmas, radius):
    """Separable gaussian blur (zero boundary) of (N, *spatial) fields,
    field i with sigmas[i]: axis 0, then axis 1 (then axis 2)."""
    kernels = gauss_kernels(sigmas, radius)
    for axis in range(fields.dim() - 1):
        fields = _blur_axis(fields, kernels, axis)
    return fields


def smooth_field(field, sigma, radius):
    """Separable gaussian blur (zero boundary) of one 2D or 3D field (a
    tensor) with a scalar sigma: `smooth_fields` of a batch of one."""
    sigmas = torch.full((1,), float(sigma), dtype=torch.float32,
                        device=field.device)
    return smooth_fields(field[None], sigmas, radius)[0]


def _oob_and_cells(px, py, H, W):
    oob = (px < 0) | (px > H - 1) | (py < 0) | (py > W - 1)
    x0 = torch.clamp(torch.floor(px), 0, H - 2)
    y0 = torch.clamp(torch.floor(py), 0, W - 2)
    return oob, x0, y0


def _bilinear(images, px, py, fill):
    """images (B, H, W, C) at pixel coordinates px, py (B, H, W); fill
    (B, C) out of bounds."""
    B, H, W, C = images.shape
    oob, x0, y0 = _oob_and_cells(px, py, H, W)
    fx, fy = px - x0, py - y0
    x0, y0 = x0.long(), y0.long()
    flat = images.reshape(B * H * W, C)
    base = torch.arange(B, device=images.device)[:, None, None] * (H * W)
    out = 0.0
    for dx, dy, w in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, (1 - fx) * fy),
                      (1, 0, fx * (1 - fy)), (1, 1, fx * fy)):
        idx = base + (x0 + dx) * W + (y0 + dy)
        out = out + flat.index_select(0, idx.reshape(-1)).reshape(
            B, H, W, C) * w[..., None]
    return torch.where(oob[..., None], fill[:, None, None, :], out)


def _nearest(labels, px, py):
    """labels (B, H, W) at pixel coordinates px, py; 0 out of bounds."""
    B, H, W = labels.shape
    oob, x0, y0 = _oob_and_cells(px, py, H, W)
    xi = torch.where(px - x0 <= 0.5, x0, x0 + 1).long()
    yi = torch.where(py - y0 <= 0.5, y0, y0 + 1).long()
    base = torch.arange(B, device=labels.device)[:, None, None] * (H * W)
    out = labels.reshape(-1).index_select(
        0, (base + xi * W + yi).reshape(-1)).reshape(B, H, W)
    return torch.where(oob, torch.zeros_like(out), out)


def elastic_deform_2d_fields(images, labels, fx, fy, alphas, sigmas,
                             apply_mask, bg_values, radius=64):
    """Deform a batch with given noise fields.

    images (B, d, d, C) float; labels (B, d, d) float labels; fx, fy
    (B, d, d) uniform noise in [-1, 1); alphas, sigmas (B,) float;
    apply_mask (B,) bool; bg_values (B, C) fill. Returns (images,
    labels) deformed where apply_mask is set."""
    B, d, _, C = images.shape
    dev = images.device
    alphas = torch.as_tensor(alphas, dtype=torch.float32, device=dev)
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32, device=dev)
    apply_mask = torch.as_tensor(apply_mask, dtype=torch.bool, device=dev)
    bg = torch.as_tensor(bg_values, dtype=torch.float32,
                         device=dev).reshape(B, -1).expand(B, C)
    disp = smooth_fields(torch.cat([fx, fy]).float(), sigmas.repeat(2),
                         radius)
    disp = disp * alphas.repeat(2)[:, None, None]
    grid = torch.arange(d, dtype=torch.float32, device=dev)
    gx = grid[None, :, None] + disp[:B]
    gy = grid[None, None, :] + disp[B:]
    im_out = _bilinear(images.float(), gx, gy, bg)
    lab_out = _nearest(labels, gx, gy)
    im_out = torch.where(apply_mask[:, None, None, None], im_out,
                         images.float())
    lab_out = torch.where(apply_mask[:, None, None], lab_out, labels)
    return im_out, lab_out


def elastic_deform_2d_batch(key, images, labels, alphas, sigmas,
                            apply_mask, bg_values, radius=64):
    """`elastic_deform_2d_fields` with the two noise fields drawn as the
    JAX function draws them from `key` (a `prng.PRNGKey`), on the images'
    device."""
    B, d = images.shape[:2]
    fx, fy = (prng.uniform(k, (B, d, d), -1.0, 1.0, device=images.device)
              for k in prng.split(key))
    return elastic_deform_2d_fields(images, labels, fx, fy, alphas, sigmas,
                                    apply_mask, bg_values, radius)


def elastic_deform_3d_fields(images, labels, f0, f1, f2, alphas, sigmas,
                             apply_mask, bg_values, radius=52):
    """Deform a batch of 3D boxes with given noise fields.

    images (B, d, d, d, C) float; labels (B, d, d, d) float labels; f0,
    f1, f2 (B, d, d, d) uniform noise in [-1, 1), the displacements along
    axes 0, 1, 2; alphas, sigmas (B,) float; apply_mask (B,) bool;
    bg_values (B, C) fill. Returns (images, labels) deformed where
    apply_mask is set."""
    B, d = images.shape[:2]
    C = images.shape[-1]
    dev = images.device
    alphas = torch.as_tensor(alphas, dtype=torch.float32, device=dev)
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32, device=dev)
    apply_mask = torch.as_tensor(apply_mask, dtype=torch.bool, device=dev)
    bg = np.array(np.broadcast_to(
        np.asarray(bg_values, np.float32).reshape(B, -1), (B, C)))
    disp = smooth_fields(torch.cat([f0, f1, f2]).float(), sigmas.repeat(3),
                         radius)
    disp = (disp * alphas.repeat(3)[:, None, None, None]).reshape(
        3, B, d, d, d)
    grid = torch.arange(d, dtype=torch.float32, device=dev)
    pts = torch.stack([grid[None, :, None, None] + disp[0],
                       grid[None, None, :, None] + disp[1],
                       grid[None, None, None, :] + disp[2]], dim=-1)
    # each sample is a slot of its own: origin 0, spacing 1, full extent
    slots, origins = np.arange(B), np.zeros((B, 3), np.float32)
    spacings = np.ones((B, 3), np.float32)
    im_out = grid_gather_pool(images.float(), slots, origins, spacings, pts,
                              fills=bg)
    lab_out = grid_gather_pool(labels.float()[..., None], slots, origins,
                               spacings, pts, method="nearest")[..., 0]
    im_out = torch.where(apply_mask[:, None, None, None, None], im_out,
                         images.float())
    lab_out = torch.where(apply_mask[:, None, None, None], lab_out,
                          labels.float())
    return im_out, lab_out


def elastic_deform_3d_batch(key, images, labels, alphas, sigmas,
                            apply_mask, bg_values, radius=52):
    """`elastic_deform_3d_fields` with the three noise fields drawn as the
    JAX function draws them from `key` (a `prng.PRNGKey`), on the images'
    device."""
    B, d = images.shape[:2]
    fields = [prng.uniform(k, (B, d, d, d), -1.0, 1.0, device=images.device)
              for k in prng.split(key, 3)]
    return elastic_deform_3d_fields(images, labels, *fields, alphas, sigmas,
                                    apply_mask, bg_values, radius)
