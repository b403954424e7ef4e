"""Uniform-grid interpolation by gathers, in torch: the exact resampler of
the predictor's gather path and the training sampler's plane gathers.

Port of the gather half of `multiplanarunet_tpu/ops/interp.py`, with
`sample_plane` / `sample_plane_batch` (one oblique plane, or a batch of
independently oriented planes, linear for images and nearest for
labels), the per-view inference pair `sample_plane_stack` (a view's
unpacked (d, d, P, C) plane stack) and `map_view_pred_to_voxels` (its
prediction gathered back at voxel positions), the pooled training
sampler's `grid_gather_pool` / `sample_plane_batch_pool` (B planes from
B slots of a volume pool in one batched gather), and the 3D path's
isotropic boxes: `sample_box` / `sample_box_batch` (boxes of one volume),
`sample_box_batch_pool` (B boxes from B pool slots) and
`scatter_box_pred` (box predictions added onto their nearest voxels, as
one `index_add_`). Sample
axes are uniform (centered voxel axes spaced by pixdim; plane axes are a
linspace), so a point's cell index is a multiply-add. Boundary semantics
are the JAX package's: a point is out of bounds iff it lies outside
[0, n-1] in index units on any axis (n the *valid* extent, which may be
smaller than a bucket-padded array); in-bounds cells clamp to [0, n-2];
nearest picks the lower voxel when frac <= 0.5. Out-of-bounds points take
a per-channel fill vector.

Flat indices are int64: at 512^3 a corner-packed volume holds
512^3 * 8 * C elements, past 2^31.
"""

from __future__ import annotations

import numpy as np
import torch

# Points per gather call in the chunked samplers: bounds the temporaries
# (coordinates, int64 indices, gathered rows) whatever the volume size
_CHUNK_POINTS = 1 << 24


def _f32(x):
    return float(np.float32(x))


def _as_f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _index_parts(points, origin, spacing, shape3):
    """(i0 int64 (..., 3), frac float32 (..., 3), oob bool (...,)) of
    real-space points on the grid (origin, spacing) of valid extent
    shape3 (a tuple, or a float32 tensor broadcasting against points)."""
    t = (points - origin) / spacing
    n = torch.as_tensor(np.asarray(shape3, np.float32), device=points.device) \
        if not torch.is_tensor(shape3) else shape3
    oob = ((t < 0.0) | (t > (n - 1.0))).any(dim=-1)
    i0 = torch.minimum(torch.clamp(torch.floor(t), min=0.0), n - 2.0)
    frac = t - i0
    return i0.to(torch.int64), frac, oob


def _flat_gather(vol_flat, ix, iy, iz, D1, D2):
    """Rows (..., C) of a flattened (D0*D1*D2, C) volume."""
    flat = (ix * D1 + iy) * D2 + iz
    rows = vol_flat.index_select(0, flat.reshape(-1))
    return rows.reshape(flat.shape + (vol_flat.shape[-1],))


def _fill_vector(fill, C, dtype, device):
    if fill is None:
        return torch.zeros((C,), dtype=dtype, device=device)
    fill = torch.as_tensor(np.asarray(fill, np.float32), device=device)
    return torch.broadcast_to(fill, (C,)).to(dtype)


def grid_gather(values, origin, spacing, points, method="linear", fill=None,
                valid_shape=None):
    """Interpolate values (D0, D1, D2, C) on a uniform grid at real-space
    points (..., 3) float32. method: 'linear', 'nearest' or 'knn' (the
    nearest voxel and its six axis neighbours vote, normalised to a unit
    channel sum). fill: scalar or (C,) out-of-bounds value (0 if None),
    in values' dtype. valid_shape: the true extent when values is padded
    beyond it. Returns (..., C): float32 for linear over a lower-precision
    input (the JAX promotion), values' dtype otherwise."""
    if values.dim() != 4:
        raise ValueError(f"values must be rank-4 (D0,D1,D2,C), got "
                         f"{tuple(values.shape)}")
    D0, D1, D2, C = values.shape
    dev = values.device
    origin = _as_f32(origin, dev)
    spacing = _as_f32(spacing, dev)
    fillv = _fill_vector(fill, C, values.dtype, dev)
    bounds = (D0, D1, D2) if valid_shape is None else tuple(
        int(s) for s in valid_shape)
    i0, frac, oob = _index_parts(points, origin, spacing, bounds)
    vol_flat = values.reshape(-1, C)

    if method == "nearest":
        idx = torch.where(frac <= 0.5, i0, i0 + 1)
        out = _flat_gather(vol_flat, idx[..., 0], idx[..., 1], idx[..., 2],
                           D1, D2)
    elif method == "linear":
        fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
        ix, iy, iz = i0[..., 0], i0[..., 1], i0[..., 2]
        out = None
        for dx in (0, 1):
            wx = fx if dx else (1.0 - fx)
            for dy in (0, 1):
                wy = fy if dy else (1.0 - fy)
                for dz in (0, 1):
                    wz = fz if dz else (1.0 - fz)
                    corner = _flat_gather(vol_flat, ix + dx, iy + dy,
                                          iz + dz, D1, D2)
                    contrib = corner * (wx * wy * wz)[..., None]
                    out = contrib if out is None else out + contrib
    elif method in ("knn", "kNN"):
        idx = torch.where(frac <= 0.5, i0, i0 + 1)
        hi = torch.as_tensor(bounds, dtype=torch.int64, device=dev) - 1
        out = None
        for d in ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0),
                  (0, 1, 0), (0, 0, -1), (0, 0, 1)):
            j = idx + torch.as_tensor(d, dtype=torch.int64, device=dev)
            j = torch.minimum(torch.clamp(j, min=0), hi)
            v = _flat_gather(vol_flat, j[..., 0], j[..., 1], j[..., 2],
                             D1, D2)
            out = v if out is None else out + v
        out = out / out.sum(dim=-1, keepdim=True)
    else:
        raise ValueError(f"Unknown method '{method}'")
    return torch.where(oob[..., None], fillv.to(out.dtype), out)


# --------------------------------------------------------------------- planes
def plane_points(basis, offset, span, dim, device="cpu"):
    """(d, d, 3) float32 real-space positions of one oblique plane:
    point(i, j) = u * g[i] + v * g[j] + n_hat * offset with
    g = linspace(-span//2, span//2, dim); basis is the (u, v, n_hat)
    column matrix of `ops.geometry.plane_basis`."""
    hd = _f32(np.floor_divide(np.float32(span), np.float32(2.0)))
    g = torch.linspace(-hd, hd, int(dim), dtype=torch.float32, device=device)
    b = _as_f32(basis, device)
    u, v, n = b[:, 0], b[:, 1], b[:, 2]
    return (g[:, None, None] * u[None, None, :]
            + g[None, :, None] * v[None, None, :]
            + _f32(offset) * n[None, None, :])


def _rotate(pts, rot):
    """Points (..., 3) @ rot.T; rot a (3, 3) tensor, array or None (the
    identity)."""
    if rot is None:
        return pts
    return pts @ torch.as_tensor(rot, dtype=torch.float32,
                                 device=pts.device).T


def sample_plane(volume, origin, spacing, rot, basis, offset, span, dim,
                 fill, method="linear", valid_shape=None):
    """One oblique plane (d, d, C) of `volume` (X, Y, Z, C): the points of
    `plane_points(basis, offset, span, dim)`, rotated by `rot` (scanner ->
    grid alignment), sampled with `grid_gather`."""
    pts = plane_points(basis, offset, span, dim, device=volume.device)
    return grid_gather(volume, origin, spacing, _rotate(pts, rot),
                       method=method, fill=fill, valid_shape=valid_shape)


def _plane_stack_chunks(basis, rot, offsets, span, dim, device):
    """Yield the (d, d, p, 3) float32 points of consecutive chunks of a
    stack of parallel planes (plane p at offsets[p] along n_hat, then
    rotated by `rot`, the identity if None), at most _CHUNK_POINTS points
    per chunk so the gather temporaries stay bounded at any size."""
    base = plane_points(basis, 0.0, span, dim, device=device)
    n = _as_f32(basis, device)[:, 2]
    if rot is None:
        rot_t = torch.eye(3, device=device)
    else:
        rot_t = torch.as_tensor(rot, dtype=torch.float32, device=device).T
    offs = _as_f32(offsets, device)
    d = int(dim)
    per_chunk = max(1, _CHUNK_POINTS // (d * d))
    for p0 in range(0, offs.shape[0], per_chunk):
        o = offs[p0:p0 + per_chunk]
        yield (base[:, :, None, :] + o[None, None, :, None] * n) @ rot_t


def sample_plane_stack(volume, origin, spacing, rot, basis, offsets, span,
                       dim, fill, method="linear", valid_shape=None):
    """(d, d, P, C) stack of parallel planes along one view of `volume`
    (X, Y, Z, C), the planes on axis 2 (the JAX package's layout): plane
    p sits at offsets[p] along n_hat, its points rotated by `rot`
    (scanner -> grid alignment; an array, a tensor or None for the
    identity) and sampled by `grid_gather` (linear or nearest, `fill`
    out of bounds, `valid_shape` the true extent of a padded volume),
    in float32 points, in chunks of planes."""
    parts = [grid_gather(volume, origin, spacing, pts, method=method,
                         fill=fill, valid_shape=valid_shape)
             for pts in _plane_stack_chunks(basis, rot, offsets, span, dim,
                                            volume.device)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)


def _plane_batch_points(bases, offsets, span, dim, device):
    """(B, d, d, 3) float32 points of B planes: plane b has basis bases[b]
    (3, 3) and offset offsets[b] along its normal (`plane_points` per
    plane, in its order of operations)."""
    hd = _f32(np.floor_divide(np.float32(span), np.float32(2.0)))
    g = torch.linspace(-hd, hd, int(dim), dtype=torch.float32, device=device)
    b = _as_f32(bases, device)
    u, v, n = b[:, None, None, :, 0], b[:, None, None, :, 1], b[:, None,
                                                                None, :, 2]
    off = _as_f32(offsets, device)[:, None, None, None]
    return g[None, :, None, None] * u + g[None, None, :, None] * v + off * n


def sample_plane_batch(volume, origin, spacing, rot, bases, offsets, span,
                       dim, fill, method="linear", valid_shape=None):
    """A batch of independently oriented planes (B, d, d, C): plane b has
    basis bases[b] (3, 3) and offset offsets[b] along its normal."""
    pts = _plane_batch_points(bases, offsets, span, dim, volume.device)
    return grid_gather(volume, origin, spacing, _rotate(pts, rot),
                       method=method, fill=fill, valid_shape=valid_shape)


# ------------------------------------------------------------- pooled path
def grid_gather_pool(pool, slots, origins, spacings, points, method="linear",
                     fills=None, valid_shapes=None):
    """`grid_gather` against B slots of a (N, X, Y, Z, C) volume pool, one
    per sample of a leading batch axis: sample b reads slot slots[b] at
    points[b] (..., 3) with its own origins[b], spacings[b] (3,), fill
    fills[b] (C,) (0 if None) and valid extent valid_shapes[b] (3,) (the
    slot's padded shape if None). The math is `grid_gather`'s (linear or
    nearest), with the flat index offset by slot * X*Y*Z: the batched form
    of the JAX package's vmapped `grid_gather_pool`, in one gather per
    corner for the whole batch. Indices are int64: thirty 256^3 slots of
    two channels hold more than 2^31 elements."""
    N, X, Y, Z, C = pool.shape
    dev = pool.device
    lead = (points.shape[0],) + (1,) * (points.dim() - 2)
    origin = _as_f32(origins, dev).reshape(lead + (3,))
    spacing = _as_f32(spacings, dev).reshape(lead + (3,))
    n = (torch.tensor([X, Y, Z], dtype=torch.float32, device=dev)
         if valid_shapes is None
         else _as_f32(valid_shapes, dev).reshape(lead + (3,)))
    i0, frac, oob = _index_parts(points, origin, spacing, n)
    base = torch.as_tensor(np.asarray(slots, np.int64),
                           device=dev).reshape(lead) * (X * Y * Z)
    flat_pool = pool.reshape(-1, C)

    def g(ix, iy, iz):
        idx = base + (ix * Y + iy) * Z + iz
        rows = flat_pool.index_select(0, idx.reshape(-1))
        return rows.reshape(idx.shape + (C,))

    if method == "nearest":
        idx = torch.where(frac <= 0.5, i0, i0 + 1)
        out = g(idx[..., 0], idx[..., 1], idx[..., 2])
    elif method == "linear":
        fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
        ix, iy, iz = i0[..., 0], i0[..., 1], i0[..., 2]
        out = None
        for dx in (0, 1):
            wx = fx if dx else (1.0 - fx)
            for dy in (0, 1):
                wy = fy if dy else (1.0 - fy)
                for dz in (0, 1):
                    wz = fz if dz else (1.0 - fz)
                    contrib = (g(ix + dx, iy + dy, iz + dz)
                               * (wx * wy * wz)[..., None])
                    out = contrib if out is None else out + contrib
    else:
        raise ValueError(f"Unknown pool gather method '{method}'")
    fillv = (torch.zeros((C,), dtype=pool.dtype, device=dev)
             if fills is None else
             _as_f32(fills, dev).reshape(lead + (C,)).to(pool.dtype))
    return torch.where(oob[..., None], fillv.to(out.dtype), out)


def sample_plane_batch_pool(pool, slots, origins, spacings, rots, bases,
                            offsets, span, dim, fills, method="linear",
                            valid_shapes=None):
    """B independently oriented planes (B, d, d, C) from B (possibly
    different) slots of a (N, X, Y, Z, C) volume pool in one batched
    gather: plane b has basis bases[b] (3, 3) and offset offsets[b], is
    rotated by rots[b] (3, 3) (scanner -> grid alignment) and read from
    slot slots[b] with origins[b], spacings[b], fills[b] (C,) and
    valid_shapes[b] (3,), all host arrays. No per-sample loop."""
    dev = pool.device
    pts = _plane_batch_points(bases, offsets, span, dim, dev)
    rot_t = _as_f32(rots, dev).transpose(-1, -2)[:, None]   # (B, 1, 3, 3)
    return grid_gather_pool(pool, slots, origins, spacings, pts @ rot_t,
                            method=method, fills=fills,
                            valid_shapes=valid_shapes)


# ----------------------------------------------------------------------- boxes
def _linspace_f32(start, stop, num):
    """jnp.linspace(start, stop, num) in float32 over the last axis of
    (..., 1) starts and stops: start * (1 - i/(num-1)) + stop *
    i/(num-1), with the last point exactly stop (the JAX formula, which
    torch.linspace does not round alike). i/(num-1) is divided on the
    host: a card's torch divides by a Python scalar as a multiplication by
    its reciprocal, which rounds differently."""
    div = int(num) - 1
    step = torch.from_numpy(np.arange(div, dtype=np.float32)
                            / np.float32(div)).to(start.device)
    out = start * (1.0 - step) + stop * step
    return torch.cat([out, stop], dim=-1)


def _times(pts, m):
    """pts (..., 3) @ m (..., 3, 3) as three elementwise products summed in
    a fixed order: unlike a BLAS product, the same float32 result on the
    host and on a card."""
    return ((pts[..., 0:1] * m[..., 0, :] + pts[..., 1:2] * m[..., 1, :])
            + pts[..., 2:3] * m[..., 2, :])


def _box_points(corners, right, real_box_dim, box_dim, device):
    """(B, d, d, d, 3) float32 real-space points of B isotropic boxes in
    the JAX package's order of operations: a linspace from corner to
    corner + real_box_dim per axis, the meshgrid, then (p - c) @ right[b]
    + c about the mean c of the box's points (right = box_rot.T rotates
    the box forward), kept even for an identity rotation. The mean is
    accumulated in float64 and rounded to float32 (the JAX package
    accumulates in float32, in XLA's order), so that it, and the points,
    are the same on the host and on a card."""
    start = _as_f32(corners, device).reshape(-1, 3, 1)
    axes = _linspace_f32(start, start + _f32(real_box_dim), box_dim)
    B, d = axes.shape[0], int(box_dim)
    pts = torch.stack([
        axes[:, 0, :, None, None].expand(B, d, d, d),
        axes[:, 1, None, :, None].expand(B, d, d, d),
        axes[:, 2, None, None, :].expand(B, d, d, d)], dim=-1)
    center = pts.reshape(B, -1, 3).double().mean(dim=1).float()[
        :, None, None, None]
    right = _as_f32(right, device).reshape(B, 1, 1, 1, 3, 3)
    return _times(pts - center, right) + center


def _transposed(mats):
    """(B, 3, 3) host matrices, each transposed."""
    return np.swapaxes(np.asarray(mats, np.float32).reshape(-1, 3, 3), 1, 2)


def _box_rotate(pts, rot):
    """Box points (B, d, d, d, 3) @ rot.T, for one (3, 3) rot (a tensor
    or an array) or one per box (B, 3, 3), by `_times`."""
    rot_t = torch.as_tensor(rot, dtype=torch.float32,
                            device=pts.device).transpose(-1, -2)
    if rot_t.dim() == 3:
        rot_t = rot_t[:, None, None, None]
    return _times(pts, rot_t)


def sample_box_batch(volume, origin, spacing, rot, corners, real_box_dim,
                     box_rots, box_dim, fill, method="linear",
                     valid_shape=None):
    """K isotropic boxes (K, d, d, d, C) of one volume (X, Y, Z, C): box k
    has its corner at corners[k] (3,), spans real_box_dim and is rotated
    by box_rots[k] (3, 3) about its center; the points are then rotated
    by `rot` (scanner -> grid alignment) and sampled with
    `grid_gather`."""
    pts = _box_points(corners, _transposed(box_rots), real_box_dim, box_dim,
                      volume.device)
    return grid_gather(volume, origin, spacing, _box_rotate(pts, rot),
                       method=method, fill=fill, valid_shape=valid_shape)


def sample_box(volume, origin, spacing, rot, corner, real_box_dim, box_rot,
               box_dim, fill, method="linear", valid_shape=None):
    """One isotropic box (d, d, d, C): `sample_box_batch` of one box."""
    return sample_box_batch(
        volume, origin, spacing, rot, np.asarray(corner)[None],
        real_box_dim, np.asarray(box_rot)[None], box_dim, fill,
        method=method, valid_shape=valid_shape)[0]


def sample_box_batch_pool(pool, slots, origins, spacings, rots, corners,
                          box_rots, real_box_dim, box_dim, fills,
                          method="linear", valid_shapes=None):
    """B isotropic boxes (B, d, d, d, C) from B (possibly different) slots
    of a (N, X, Y, Z, C) volume pool in one batched gather: box b has its
    corner at corners[b], is rotated by box_rots[b] about its center and
    by rots[b] (scanner -> grid alignment), and is read from slot
    slots[b] with origins[b], spacings[b], fills[b] (C,) and
    valid_shapes[b] (3,), all host arrays (the JAX package's vmapped
    `sample_box_batch_pool`)."""
    dev = pool.device
    pts = _box_points(corners, _transposed(box_rots), real_box_dim, box_dim,
                      dev)
    return grid_gather_pool(pool, slots, origins, spacings,
                            _box_rotate(pts, rots), method=method,
                            fills=fills, valid_shapes=valid_shapes)


def scatter_box_pred(pred_vol, preds, corners, real_box_dim, inv_box_rots,
                     rot, origin, spacing, box_dim, valid_shape):
    """Add B box predictions preds (B, d, d, d, C) onto the nearest voxels
    of the accumulator pred_vol (X, Y, Z, C) float32, in place, and return
    it (the JAX package's `scatter_box_pred`, box after box).

    Box b was sampled at its grid rotated forward by box_rot about its
    center, so sample (i, j, k) lies at (p - c) @ inv_box_rots[b] + c
    (inv = box_rot.T for a rotation), then rot.T (scanner -> grid); its
    voxel is round((p - origin) / spacing), half to even as jnp.round;
    voxels outside [0, valid_shape) are dropped. One index_add_ over the
    flat (X*Y*Z, C) accumulator, the boxes' voxels in box order (summed in
    that order on the host; by atomics, in no fixed order, on a card)."""
    X, Y, Z, C = pred_vol.shape
    dev = pred_vol.device
    pts = _box_points(corners, inv_box_rots, real_box_dim, box_dim, dev)
    idx = torch.round((_box_rotate(pts, rot) - _as_f32(origin, dev))
                      / _as_f32(spacing, dev)).to(torch.int64)
    n = torch.as_tensor(np.asarray(valid_shape, np.int64), device=dev)
    inb = ((idx >= 0) & (idx < n)).all(dim=-1).reshape(-1)
    flat = ((idx[..., 0] * Y + idx[..., 1]) * Z + idx[..., 2]).reshape(-1)
    pred_vol.view(-1, C).index_add_(
        0, flat[inb], preds.reshape(-1, C)[inb].to(pred_vol.dtype))
    return pred_vol


# --------------------------------------------------------- packed-corner path
_CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def pack_corners(volume):
    """(X, Y, Z, C) -> (X, Y, Z, 8, C): entry [x, y, z, k] holds
    volume[x+dx, y+dy, z+dz] for the k-th corner offset, edge-padded at
    the high end (those rows are never read: cells clamp to n-2)."""
    p = volume
    for axis in range(3):
        p = torch.cat([p, p.narrow(axis, p.shape[axis] - 1, 1)], dim=axis)
    X, Y, Z, _ = volume.shape
    return torch.stack([p[dx:dx + X, dy:dy + Y, dz:dz + Z]
                        for dx, dy, dz in _CORNERS], dim=3)


def grid_gather_packed(packed, origin, spacing, points, fill=None,
                       valid_shape=None):
    """Trilinear interpolation from a corner-packed (X, Y, Z, 8, C) volume
    with one row gather per point; blends in float32. Returns (..., C)
    float32 (fill rounded to packed's dtype first, as in the JAX
    package)."""
    X, Y, Z, _, C = packed.shape
    dev = packed.device
    origin = _as_f32(origin, dev)
    spacing = _as_f32(spacing, dev)
    fillv = _fill_vector(fill, C, packed.dtype, dev).float()
    bounds = (X, Y, Z) if valid_shape is None else tuple(
        int(s) for s in valid_shape)
    i0, frac, oob = _index_parts(points, origin, spacing, bounds)
    flat = (i0[..., 0] * Y + i0[..., 1]) * Z + i0[..., 2]
    rows = packed.reshape(-1, 8, C).index_select(0, flat.reshape(-1))
    rows = rows.reshape(flat.shape + (8, C)).float()
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    wx = torch.stack([1.0 - fx, fx], -1)
    wy = torch.stack([1.0 - fy, fy], -1)
    wz = torch.stack([1.0 - fz, fz], -1)
    w = (wx[..., :, None, None] * wy[..., None, :, None]
         * wz[..., None, None, :]).reshape(frac.shape[:-1] + (8,))
    out = (rows * w[..., None]).sum(dim=-2)
    return torch.where(oob[..., None], fillv, out)


def sample_plane_stack_packed(packed, origin, spacing, rot, basis, offsets,
                              span, dim, fill, valid_shape=None):
    """(d, d, P, C) float32 stack of parallel planes along one view from a
    corner-packed volume: plane p sits at offsets[p] along n_hat, and the
    points are rotated by `rot` (the scanner -> grid alignment, identity
    when the affine is axis-aligned) before sampling. Sampled in chunks of
    planes, so the temporaries stay bounded at any volume size."""
    parts = [grid_gather_packed(packed, origin, spacing, pts, fill=fill,
                                valid_shape=valid_shape)
             for pts in _plane_stack_chunks(basis, rot, offsets, span, dim,
                                            packed.device)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)


# ------------------------------------------------------ prediction remapping
def map_view_pred_to_voxels(pred, plane_span_axis0, offsets_axis2, inv_basis,
                            voxel_points, method="nearest"):
    """A (d, d, P, C) per-view prediction stack gathered at voxel
    positions: voxel_points (..., 3) centered real-space positions (an
    array or a tensor), taken to plane coordinates by inv_basis (3, 3);
    plane_span_axis0 and offsets_axis2 are the [start, step] of the
    in-plane axis (u and v) and of the plane-offset axis. Out-of-bounds
    voxels get the one-hot background (class 0). Returns (..., C) on
    pred's device, in pred's dtype for nearest."""
    dev = pred.device
    fill = np.zeros((pred.shape[-1],), np.float32)
    fill[0] = 1.0
    pts = torch.as_tensor(voxel_points, dtype=torch.float32, device=dev)
    pts = pts @ torch.as_tensor(inv_basis, dtype=torch.float32,
                                device=dev).T
    a0, a1 = (np.float32(x) for x in plane_span_axis0)
    o0, o1 = (np.float32(x) for x in offsets_axis2)
    return grid_gather(pred, (a0, a0, o0), (a1, a1, o1), pts, method=method,
                       fill=fill)


def _view_slab_mapper(pred, plane_start, plane_step, offset_start,
                      offset_step, M, t, out_shape, valid_planes, method,
                      x_slab):
    """(x_slab, n_slabs, one_slab): one_slab(i) maps X-slab i of the voxel
    grid from the (d, d, P_pad, C) prediction stack, generating the voxel
    -> plane coordinates M @ (i, j, k) + t in float32 in the JAX package's
    order. Past 256^3 voxels the grid is cut into slabs so the coordinate
    grid never exists whole."""
    X, Y, Z = (int(s) for s in out_shape)
    C = pred.shape[-1]
    dev = pred.device
    fill = np.zeros((C,), np.float32)
    fill[0] = 1.0
    origin = (plane_start, plane_start, offset_start)
    spacing = (plane_step, plane_step, offset_step)
    valid = (pred.shape[0], pred.shape[1], int(valid_planes))
    M = np.asarray(M, np.float32)
    t = np.asarray(t, np.float32)
    if x_slab is None:
        x_slab = X if X * Y * Z <= 256 ** 3 else max(32, X // 16)
    if X % x_slab:
        x_slab = max(d for d in range(1, x_slab + 1) if X % d == 0)
    n_slabs = X // x_slab
    jj = torch.arange(Y, dtype=torch.float32, device=dev)[None, :, None]
    kk = torch.arange(Z, dtype=torch.float32, device=dev)[None, None, :]

    def one_slab(i):
        ii = (float(i * x_slab)
              + torch.arange(x_slab, dtype=torch.float32, device=dev)
              )[:, None, None]
        pts = torch.stack(
            [(ii * _f32(M[a, 0]) + jj * _f32(M[a, 1])
              + kk * _f32(M[a, 2]) + _f32(t[a])) for a in range(3)],
            dim=-1)
        return grid_gather(pred, origin, spacing, pts, method=method,
                           fill=fill, valid_shape=valid)

    return x_slab, n_slabs, one_slab


def map_view_pred_affine(pred, plane_start, plane_step, offset_start,
                         offset_step, M, t, out_shape, valid_planes,
                         method="nearest", x_slab=None):
    """Map a (d, d, P_pad, C) per-view prediction stack onto the (X, Y, Z)
    voxel grid: voxel index v reads the stack at plane coordinates
    M @ v + t (padded tail planes past valid_planes are out of bounds,
    out-of-bounds voxels get the one-hot background). Returns
    (X, Y, Z, C) in pred's dtype for nearest."""
    X, Y, Z = (int(s) for s in out_shape)
    x_slab, n_slabs, one_slab = _view_slab_mapper(
        pred, plane_start, plane_step, offset_start, offset_step, M, t,
        (X, Y, Z), valid_planes, method, x_slab)
    if n_slabs == 1:
        return one_slab(0)
    return torch.cat([one_slab(i) for i in range(n_slabs)], dim=0)


def accum_view_pred_affine(pred, plane_start, plane_step, offset_start,
                           offset_step, M, t, accum, w, valid_planes,
                           want_argmax=False, method="nearest",
                           x_slab=None):
    """`map_view_pred_affine` fused with the fusion accumulation: updates
    the float32 accum (X, Y, Z, C) in place, slab by slab
    (accum[x0:x1] += w * mapped), so only one slab's mapped volume is ever
    live. Returns the per-voxel argmax of the mapped volume as uint8
    (X, Y, Z) when want_argmax, else None."""
    X, Y, Z = accum.shape[:3]
    x_slab, n_slabs, one_slab = _view_slab_mapper(
        pred, plane_start, plane_step, offset_start, offset_step, M, t,
        (X, Y, Z), valid_planes, method, x_slab)
    w = torch.as_tensor(w, dtype=torch.float32, device=accum.device)
    side = (torch.empty((X, Y, Z), dtype=torch.uint8, device=accum.device)
            if want_argmax else None)
    for i in range(n_slabs):
        mapped = one_slab(i).float()
        x0 = i * x_slab
        accum[x0:x0 + x_slab] += w * mapped
        if side is not None:
            side[x0:x0 + x_slab] = mapped.argmax(dim=-1).to(torch.uint8)
    return side


# ---------------------------------------------------------------- numpy twin
def grid_gather_np(values, origin, spacing, points, method="linear",
                   fill=None):
    """Reference numpy implementation of `grid_gather` (linear and
    nearest), for tests and host-side use."""
    values = np.asarray(values)
    D0, D1, D2, C = values.shape
    points = np.asarray(points, np.float32)
    t = (points - np.asarray(origin)) / np.asarray(spacing)
    n = np.array([D0, D1, D2], np.float32)
    oob = np.any((t < 0) | (t > (n - 1)), axis=-1)
    i0 = np.clip(np.floor(t), 0, n - 2).astype(np.int64)
    frac = (t - i0).astype(np.float32)
    flat = values.reshape(-1, C)

    def g(ix, iy, iz):
        return flat[(ix * D1 + iy) * D2 + iz]

    if method == "nearest":
        idx = np.where(frac <= 0.5, i0, i0 + 1)
        out = g(idx[..., 0], idx[..., 1], idx[..., 2])
    else:
        out = np.zeros(points.shape[:-1] + (C,), np.float32)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    w = ((frac[..., 0] if dx else 1 - frac[..., 0])
                         * (frac[..., 1] if dy else 1 - frac[..., 1])
                         * (frac[..., 2] if dz else 1 - frac[..., 2]))
                    out += g(i0[..., 0] + dx, i0[..., 1] + dy,
                             i0[..., 2] + dz) * w[..., None]
    if fill is None:
        fillv = np.zeros((C,), np.float32)
    else:
        fillv = np.broadcast_to(np.asarray(fill, np.float32), (C,))
    return np.where(oob[..., None], fillv, out)
