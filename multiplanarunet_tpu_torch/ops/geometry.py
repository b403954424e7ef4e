"""Scanner-space geometry for the predictor: view sampling, plane bases,
centered voxel axes.

Numpy copies of the functions of `multiplanarunet_tpu/ops/geometry.py`
that the inference path needs. The JAX package's module is numpy too, but
importing it pulls in jax (through its package `__init__`), so the port
carries its own copy; tests/test_torch_shear.py holds every function here
equal to the original.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np


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
