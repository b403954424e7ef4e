"""Elastic deformation of batches of 2D slices on the device, in torch.

Port of `multiplanarunet_tpu/ops/elastic.py:elastic_deform_2d_batch`
(Simard-style, as the reference's host-side elastic augmentation):

- two uniform random fields in [-1, 1) per sample (x and y displacement),
- each blurred by a separable gaussian with the sample's sigma: a static
  kernel radius (64) whose weights come from the dynamic sigma, taps past
  scipy's truncation (4 sigma) set to 0, normalised, applied as a
  zero-padded 1-D convolution along each axis in turn (scipy's
  gaussian_filter with mode='constant'),
- scaled by the sample's alpha and added to the pixel grid,
- the image warped bilinearly with an out-of-bounds fill per channel, the
  labels by nearest neighbour (frac <= 0.5 picks the lower pixel) with
  class 0 out of bounds,
- samples whose apply flag is off passed through unchanged.

`elastic_deform_2d_fields` takes the noise fields as arguments (the tests
feed it the JAX draws); `elastic_deform_2d_batch` draws them from a
torch.Generator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
    """Zero-padded 1-D convolution of each (H, W) field of `fields`
    (N, H, W) with its own kernel (N, K), along spatial `axis` (0 or
    1)."""
    n, radius = fields.shape[0], kernels.shape[1] // 2
    # (rows, N, length): the fields ride the channel axis, one group each
    moved = fields.permute(2, 0, 1) if axis == 0 else fields.permute(1, 0, 2)
    out = F.conv1d(moved, kernels[:, None, :], padding=radius, groups=n)
    return out.permute(1, 2, 0) if axis == 0 else out.permute(1, 0, 2)


def smooth_fields(fields, sigmas, radius):
    """Separable gaussian blur (zero boundary) of (N, H, W) fields, field i
    with sigmas[i]: axis 0, then axis 1."""
    kernels = gauss_kernels(sigmas, radius)
    for axis in (0, 1):
        fields = _blur_axis(fields, kernels, axis)
    return fields


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


def elastic_deform_2d_batch(images, labels, alphas, sigmas, apply_mask,
                            bg_values, generator=None, radius=64):
    """`elastic_deform_2d_fields` with the noise fields drawn uniform in
    [-1, 1) from `generator` (on the images' device)."""
    B, d = images.shape[:2]
    noise = torch.rand((2, B, d, d), generator=generator,
                       device=images.device)
    noise = noise * 2.0 - 1.0
    return elastic_deform_2d_fields(images, labels, noise[0], noise[1],
                                    alphas, sigmas, apply_mask, bg_values,
                                    radius)
