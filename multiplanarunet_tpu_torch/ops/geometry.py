"""Scanner-space geometry for the predictor and the image layer: view
sampling, plane bases and grids, centered voxel axes, physical image
extents, and the isotropic 3D boxes (grids, random placements and
rotations).

Numpy copies of the functions of `multiplanarunet_tpu/ops/geometry.py`
that the inference paths and the training samplers need. The JAX
package's module is numpy too, but importing it pulls in jax (through its
package `__init__`), so the port carries its own copy;
tests/test_torch_shear.py, tests/test_torch_sampler.py and
tests/test_torch_3d_sampler.py hold every function here equal to the
original, with the same np.random draws in the same order.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np


def mgrid_to_points(mgrid):
    """(N, D1, D2, ...) stacked mesh -> (D1*D2*..., N) point matrix."""
    mgrid = np.asarray(mgrid)
    return mgrid.reshape(mgrid.shape[0], -1).T


def points_to_mgrid(points, grid_shape):
    """(P, N) point matrix -> (N, *grid_shape) stacked mesh."""
    points = np.asarray(points)
    return points.T.reshape((points.shape[1],) + tuple(grid_shape))


def get_angle_deg(v1, v2):
    v1 = np.asarray(v1, np.float64)
    v2 = np.asarray(v2, np.float64)
    cosang = np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2))
    return np.rad2deg(np.arccos(np.clip(cosang, -1.0, 1.0)))


def rotation_matrix(axis, angle_deg=None, angle_rad=None):
    """Rodrigues rotation matrix about `axis` (counterclockwise)."""
    theta = angle_rad if angle_rad is not None else np.deg2rad(angle_deg)
    axis = np.asarray(axis, np.float64).ravel()
    axis = axis / np.linalg.norm(axis)
    half = theta / 2.0
    a = np.cos(half)
    b, c, d = -axis * np.sin(half)
    return np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c + a * d), 2 * (b * d - a * c)],
            [2 * (b * c - a * d), a * a + c * c - b * b - d * d, 2 * (c * d + a * b)],
            [2 * (b * d + a * c), 2 * (c * d - a * b), a * a + d * d - b * b - c * c],
        ]
    )


def get_pix_dim(image):
    """Voxel sizes from an object exposing .affine (norm of spatial columns)."""
    return np.linalg.norm(np.asarray(image.affine)[:3, :3], axis=0)


def get_real_image_size(image):
    shape = np.asarray(image.shape)[:3]
    return shape * get_pix_dim(image)


def get_maximum_real_dim(image):
    return float(np.max(get_real_image_size(image)))


def get_bounding_sphere_real_radius(image):
    return float(np.linalg.norm(get_real_image_size(image) / 2.0))


def get_voxel_axes_real_space(shape, affine, return_basis=False):
    """Centered, scanner-scaled axes of the voxel lattice.

    Axis k of the volume maps to real positions ``(i - (n_k-1)/2) * pixdim_k``.
    If the affine's 3x3 block is not diag(pixdims), also return the rotation
    ``rot = diag(pixdims) @ inv(basis)`` to apply to real-space query points
    before sampling on these axes. Returns (axes, transform, rot_or_None)
    when return_basis else axes.
    """
    affine = np.asarray(affine, np.float64)
    basis = affine[:3, :3]
    pixdims = np.linalg.norm(basis, axis=0)
    transform = np.diag(pixdims)
    if np.any(~np.isclose(transform, basis)):
        rot_mat = transform.dot(np.linalg.inv(basis))
    else:
        rot_mat = None
    x, y, z = (int(s) for s in shape[:3])
    axes = tuple(
        (np.arange(n, dtype=np.float32) - (n - 1) / 2) * pixdims[i]
        for i, n in enumerate((x, y, z))
    )
    if return_basis:
        return axes, transform, rot_mat
    return axes


def voxel_axes_origin_spacing(shape, affine):
    """(origin, spacing, rot_or_None) parameterization of the centered axes:
    origin[k] = -(n_k-1)/2 * pixdim_k, spacing[k] = pixdim_k."""
    axes, transform, rot = get_voxel_axes_real_space(shape, affine, return_basis=True)
    spacing = np.diagonal(transform).astype(np.float32)
    origin = np.array([a[0] for a in axes], dtype=np.float32)
    return origin, spacing, rot


def get_voxel_grid_real_space(shape, affine):
    """Real-space (scanner) position of every voxel, centered on the mean:
    a (3, X, Y, Z) float32 stacked mesh."""
    affine = np.asarray(affine, np.float64)
    shape = tuple(int(s) for s in shape[:3])
    A = affine[:3, :3]
    idx = [np.arange(n, dtype=np.float64) for n in shape]
    # position = A @ index, centered by subtracting A @ mean_index
    mean_idx = np.array([(n - 1) / 2.0 for n in shape])
    center = A.dot(mean_idx)
    xx = (
        A[:, 0][:, None, None, None] * idx[0][None, :, None, None]
        + A[:, 1][:, None, None, None] * idx[1][None, None, :, None]
        + A[:, 2][:, None, None, None] * idx[2][None, None, None, :]
    )
    return (xx - center[:, None, None, None]).astype(np.float32)


def get_random_views(N, dim=3, pos_z=True, weights=None, rng=None):
    """N uniform random unit vectors (optionally +z hemisphere, res-weighted)."""
    rng = rng or np.random
    deviates = rng.normal(size=(N, dim))
    views = deviates / np.linalg.norm(deviates, axis=1, keepdims=True)
    if pos_z:
        views[:, -1] = np.abs(views[:, -1])
    if weights is not None:
        weighted = views * np.asarray(weights)
        views = weighted / np.linalg.norm(weighted, axis=1, keepdims=True)
    return views


def sample_random_views_with_angle_restriction(n_views, min_angle_deg=60,
                                               weights=None, logger=None,
                                               rng=None):
    """Rejection-sample a set of views with pairwise angles > min_angle_deg,
    relaxing the restriction by 1 degree per failed attempt."""
    if logger is not None:
        logger(f"Generating {n_views} random views...")
    while True:
        views = get_random_views(n_views, dim=3, pos_z=True, weights=weights, rng=rng)
        angles = [get_angle_deg(v1, v2) for v1, v2 in combinations(views, 2)]
        if np.all(np.asarray(angles) > min_angle_deg):
            return views
        min_angle_deg -= 1


def plane_basis(norm_vector, noise_sd=0.0, rng=None):
    """In-plane orthonormal basis (u, v, n_hat) for a view vector, as the
    3x3 float32 matrix with those columns (conventions of the JAX package's
    `plane_basis`, which reproduce the reference sampler's orientations)."""
    rng = rng or np.random
    n_hat = np.asarray(norm_vector, np.float64).copy()
    n_hat /= np.linalg.norm(n_hat)
    if not isinstance(noise_sd, np.ndarray):
        noise_sd = rng.normal(scale=noise_sd, size=3) if noise_sd else np.zeros(3)
    n_hat = n_hat + noise_sd
    n_hat /= np.linalg.norm(n_hat)

    if np.all(n_hat[:-1] < 0.2):
        # View pointing primarily up: control in-plane orientation variability
        n_hat[:-1] = np.abs(n_hat[:-1])
    if np.all(np.isclose(n_hat[:-1], 0)):
        u = np.array([1.0, 0.0, 0.0])
        v = np.array([0.0, 1.0, 0.0])
    else:
        n_vs = n_hat.copy()
        n_vs[-1] += 1
        n_vs /= np.linalg.norm(n_vs)
        u = rotation_matrix(np.cross(n_hat, n_vs), angle_deg=-90).dot(n_hat)
        v = np.cross(n_hat, u)
    return np.column_stack((u, v, n_hat)).astype(np.float32)


def plane_basis_batch(norm_vectors, noise_sd=0.0, rng=None):
    """`plane_basis` over (N, 3) view vectors at once, (N, 3, 3) float32,
    equal to N sequential `plane_basis` calls including the rng stream
    (one normal(size=(N, 3)) draw equals N row-major size-3 draws)."""
    rng = rng or np.random
    n_hat = np.asarray(norm_vectors, np.float64).copy()
    n_hat /= np.linalg.norm(n_hat, axis=1, keepdims=True)
    if isinstance(noise_sd, np.ndarray):
        noise = noise_sd
    elif noise_sd:
        noise = rng.normal(scale=noise_sd, size=n_hat.shape)
    else:
        noise = np.zeros_like(n_hat)
    n_hat = n_hat + noise
    n_hat /= np.linalg.norm(n_hat, axis=1, keepdims=True)

    up = np.all(n_hat[:, :-1] < 0.2, axis=1)
    n_hat[up, :-1] = np.abs(n_hat[up, :-1])
    degenerate = np.all(np.isclose(n_hat[:, :-1], 0), axis=1)

    n_vs = n_hat.copy()
    n_vs[:, -1] += 1
    n_vs /= np.linalg.norm(n_vs, axis=1, keepdims=True)
    axis = np.cross(n_hat, n_vs)
    norm = np.linalg.norm(axis, axis=1, keepdims=True)
    axis = axis / np.where(norm == 0, 1.0, norm)
    # Rodrigues about `axis` by -90 degrees (`rotation_matrix`'s quaternion
    # form) applied to n_hat: u = R @ n_hat
    half = np.deg2rad(-90.0) / 2.0
    a = np.full(len(axis), np.cos(half))
    b, c, d = (-axis * np.sin(half)).T
    R = np.stack([
        np.stack([a * a + b * b - c * c - d * d, 2 * (b * c + a * d),
                  2 * (b * d - a * c)], -1),
        np.stack([2 * (b * c - a * d), a * a + c * c - b * b - d * d,
                  2 * (c * d + a * b)], -1),
        np.stack([2 * (b * d + a * c), 2 * (c * d - a * b),
                  a * a + d * d - b * b - c * c], -1),
    ], 1)
    u = np.einsum("nij,nj->ni", R, n_hat)
    v = np.cross(n_hat, u)
    u[degenerate] = (1.0, 0.0, 0.0)
    v[degenerate] = (0.0, 1.0, 0.0)
    return np.stack([u, v, n_hat], axis=-1).astype(np.float32)


def plane_axis(real_space_span, sample_dim):
    """The in-plane axis: linspace(-span//2, span//2, sample_dim), float32
    (the floor division on a float span, as the JAX package does it)."""
    hd = real_space_span // 2
    return np.linspace(-hd, hd, sample_dim).astype(np.float32)


def plane_offsets(image, n_planes, real_space_span, sample_dim):
    """The evenly spaced offsets (float32) of a view's plane stack for an
    n_planes spec: 'same' (sample_dim planes over the span), 'same+N' (N
    more, the span widened by N sample steps), 'by_radius' (the image's
    bounding sphere at the sample resolution) or a plane count."""
    span = float(real_space_span)
    sample_res = span / (sample_dim - 1)
    if n_planes == "by_radius":
        bounds = get_bounding_sphere_real_radius(image)
        n = int(2 * bounds / sample_res)
    else:
        extra = 0
        if n_planes == "same":
            n = sample_dim
        elif isinstance(n_planes, str) and n_planes.startswith("same+"):
            extra = int(n_planes.split("+")[-1])
            n = sample_dim + extra
        else:
            n = int(n_planes)
        bounds = (span + extra * sample_res) / 2
    return np.linspace(-bounds, bounds, n).astype(np.float32)


def sample_plane_grid(norm_vector, sample_dim, real_space_span,
                      offset_from_center, noise_sd=0.0, rng=None,
                      return_basis=False):
    """Real-space (3, d, d, 1) grid of one oblique plane at
    offset_from_center along the view (a host form for tests; the
    samplers generate the points on their device). rng: a numpy
    RandomState for the basis noise (np.random if None). With
    return_basis, (grid, axis, inv_basis)."""
    basis = plane_basis(norm_vector, noise_sd=noise_sd, rng=rng)
    g = plane_axis(real_space_span, sample_dim)
    uu, vv = np.meshgrid(g, g, indexing="ij")
    pts = (basis[:, 0][:, None, None] * uu[None]
           + basis[:, 1][:, None, None] * vv[None]
           + basis[:, 2][:, None, None] * np.float32(offset_from_center))
    grid = pts[:, :, :, None]
    if return_basis:
        return grid, g, np.linalg.inv(basis.astype(np.float64)).astype(
            np.float32)
    return grid


# ----------------------------------------------------------------- box grids
def sample_box_grid(real_placement, sample_dim, real_box_dim,
                    rot_mat=None, return_axes=False):
    """Real-space (3, d, d, d) grid of an isotropic box with its corner at
    `real_placement`; rotated about its center by rot_mat when given.
    With return_axes, also the three axes and the inverse rotation."""
    a, b, c = (float(x) for x in real_placement)
    axes = tuple(
        np.linspace(s, s + real_box_dim, sample_dim).astype(np.float32)
        for s in (a, b, c)
    )
    xx, yy, zz = np.meshgrid(*axes, indexing="ij")
    grid = np.stack([xx, yy, zz])
    if rot_mat is not None:
        pts = mgrid_to_points(grid)
        center = pts.mean(axis=0)
        pts = (pts - center).dot(np.asarray(rot_mat).T) + center
        grid = points_to_mgrid(pts.astype(np.float32), grid.shape[1:])
    if return_axes:
        inv = np.eye(3, dtype=np.float32) if rot_mat is None else \
            np.linalg.inv(np.asarray(rot_mat, np.float64)).astype(np.float32)
        return grid, axes, inv
    return grid


def random_box_placement(real_dims, real_box_dim, rng=None):
    """A uniform random box corner (3,) inside the sample space (each axis
    at least 1.1 box widths), centered on the origin: 3 uniform draws."""
    rng = rng or np.random
    sample_space = np.asarray(
        [max(float(i), real_box_dim * 1.1) for i in real_dims]
    )
    d = sample_space - real_box_dim
    placement = np.array([rng.uniform(0, d[i]) for i in range(3)])
    return placement - sample_space / 2.0


def random_box_rotation(noise_sd, rng=None):
    """A small random rotation matrix: a random +z-hemisphere axis and
    |angle| half-normal(noise_sd), redrawn until below 2 pi."""
    rng = rng or np.random
    axis = get_random_views(1, dim=3, pos_z=True, rng=rng)[0]
    while True:
        angle = abs(rng.normal(scale=noise_sd))
        if angle < 2 * np.pi:
            break
    return rotation_matrix(axis, angle_rad=angle)
