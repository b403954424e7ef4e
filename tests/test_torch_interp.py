"""The port's gather resampler (`ops/interp.py`) against the JAX package's
`ops/interp.py` on the same numpy inputs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multiplanarunet_tpu.ops import geometry as jgeo
from multiplanarunet_tpu.ops import interp as jint
from multiplanarunet_tpu_torch.ops import interp as tint

torch.set_num_threads(2)

ORIGIN = np.array([-7.5, -6.0, -4.5], np.float32)
SPACING = np.array([1.0, 0.8, 1.2], np.float32)


def _points(rng, n, lo=-10.0, hi=10.0):
    return rng.uniform(lo, hi, (n, 3)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_index_parts_match_jax():
    rng = np.random.RandomState(0)
    pts = _points(rng, 4000)
    # points exactly on voxel centres and on the upper bound
    pts[:50] = ORIGIN + SPACING * rng.randint(0, 9, (50, 3))
    for shape3 in ((16, 17, 9), (12, 12, 8)):
        ji0, jfr, joob = jint._index_parts(jnp.asarray(pts), ORIGIN, SPACING,
                                           shape3)
        ti0, tfr, toob = tint._index_parts(_t(pts), _t(ORIGIN), _t(SPACING),
                                           shape3)
        np.testing.assert_array_equal(ti0.numpy(), np.asarray(ji0))
        np.testing.assert_array_equal(toob.numpy(), np.asarray(joob))
        np.testing.assert_allclose(tfr.numpy(), np.asarray(jfr), atol=1e-6)


@pytest.mark.parametrize("method", ["linear", "nearest", "knn"])
@pytest.mark.parametrize("valid", [None, (13, 15, 7)])
def test_grid_gather_matches_jax(method, valid):
    """Linear and kNN in float32 within 1e-5; nearest picks the same voxel
    for >= 0.9999 of points (a frac within rounding of 0.5 may flip).
    With valid_shape the padding beyond it is never read."""
    rng = np.random.RandomState(1)
    values = rng.rand(16, 17, 9, 3).astype(np.float32)
    if method == "knn":
        values /= values.sum(-1, keepdims=True)
    pts = _points(rng, 6000).reshape(20, 300, 3)
    fill = np.array([1.0, 0.0, 0.5], np.float32)
    kw = {} if valid is None else {"valid_shape": valid}
    want = np.asarray(jint.grid_gather(values, ORIGIN, SPACING, pts,
                                       method=method, fill=fill,
                                       valid_shape=None if valid is None
                                       else jnp.asarray(valid)))
    got = tint.grid_gather(_t(values), ORIGIN, SPACING, _t(pts),
                           method=method, fill=fill, **kw).numpy()
    assert got.shape == want.shape == (20, 300, 3)
    if method == "nearest":
        assert (got == want).all(-1).mean() >= 0.9999
    else:
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_grid_gather_np_matches_jax_twin():
    rng = np.random.RandomState(2)
    values = rng.rand(10, 9, 8, 2).astype(np.float32)
    pts = _points(rng, 3000, -8, 8)
    for method in ("linear", "nearest"):
        np.testing.assert_allclose(
            tint.grid_gather_np(values, ORIGIN, SPACING, pts, method, 0.25),
            jint.grid_gather_np(values, ORIGIN, SPACING, pts, method, 0.25),
            atol=1e-6)


def test_plane_points_and_pack_corners_match_jax():
    basis = jgeo.plane_basis(np.array([0.3, -0.5, 0.8]))
    for span, dim, off in ((31.0, 32, 0.0), (40.5, 24, -3.25)):
        np.testing.assert_allclose(
            tint.plane_points(basis, off, span, dim, device="cpu").numpy(),
            np.asarray(jint.plane_points(jnp.asarray(basis), off, span,
                                         dim)), atol=1e-5)
    rng = np.random.RandomState(3)
    vol = rng.rand(7, 6, 5, 2).astype(np.float32)
    jp = np.asarray(jint.pack_corners(jnp.asarray(vol, jnp.bfloat16))
                    .astype(jnp.float32))
    tp = tint.pack_corners(_t(vol).to(torch.bfloat16)).float().numpy()
    assert tp.shape == (7, 6, 5, 8, 2)
    np.testing.assert_array_equal(tp, jp)


def test_packed_gather_and_plane_stack_match_jax():
    """A bf16 corner-packed volume of unit-range data: the single-gather
    trilinear read and a rotated plane stack within 1e-5 of JAX."""
    rng = np.random.RandomState(4)
    vol = rng.rand(20, 18, 16, 2).astype(np.float32)
    packed_j = jint.pack_corners(jnp.asarray(vol, jnp.bfloat16))
    packed_t = tint.pack_corners(_t(vol).to(torch.bfloat16))
    origin = np.array([-9.5, -8.5, -7.5], np.float32)
    spacing = np.ones(3, np.float32)
    fill = np.array([0.3, -1.0], np.float32)
    valid = (19, 18, 15)
    pts = _points(rng, 5000, -11, 11)
    want = np.asarray(jint.grid_gather_packed(packed_j, origin, spacing,
                                              pts, fill=fill,
                                              valid_shape=jnp.asarray(valid)))
    got = tint.grid_gather_packed(packed_t, origin, spacing, _t(pts),
                                  fill=fill, valid_shape=valid).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)

    rot = (jgeo.rotation_matrix([0, 0, 1], angle_deg=20)
           @ jgeo.rotation_matrix([0, 1, 0], angle_deg=-15)
           ).astype(np.float32)
    basis = jgeo.plane_basis(np.array([0.5, 0.2, 0.7]))
    offsets = np.linspace(-10, 10, 21).astype(np.float32)
    want = np.asarray(jint.sample_plane_stack_packed(
        packed_j, origin, spacing, jnp.asarray(rot), jnp.asarray(basis),
        jnp.asarray(offsets), 19.0, 20, jnp.asarray(fill),
        valid_shape=jnp.asarray(valid)))
    got = tint.sample_plane_stack_packed(packed_t, origin, spacing, rot,
                                         basis, offsets, 19.0, 20, fill,
                                         valid_shape=valid).numpy()
    assert got.shape == (20, 20, 21, 2)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _remap_case(seed, shape=(24, 20, 16), P_pad=26, valid_planes=22):
    rng = np.random.RandomState(seed)
    pred = rng.rand(20, 20, P_pad, 4).astype(np.float32)
    pred /= pred.sum(-1, keepdims=True)
    basis = jgeo.plane_basis(rng.randn(3))
    inv_b = np.linalg.inv(basis.astype(np.float64))
    A = np.diag([1.0, 0.9, 1.1])
    center = A @ ((np.asarray(shape) - 1) / 2.0)
    M = (inv_b @ A).astype(np.float32)
    t = (-inv_b @ center).astype(np.float32)
    grid = (np.float32(-9.0), np.float32(18.0 / 19), np.float32(-12.0),
            np.float32(1.0))
    return pred, grid, M, t, shape, valid_planes


@pytest.mark.parametrize("seed", [0, 1])
def test_map_view_pred_affine_matches_jax(seed):
    """Nearest remap of a bf16 prediction stack: >= 0.9999 of voxels
    exactly equal to JAX, and the slabbed map equal to the unslabbed."""
    pred, grid, M, t, shape, vp = _remap_case(seed)
    pred_j = jnp.asarray(pred, jnp.bfloat16)
    pred_t = _t(pred).to(torch.bfloat16)
    want = np.asarray(jint.map_view_pred_affine(
        pred_j, *grid, jnp.asarray(M), jnp.asarray(t), shape, vp)
        .astype(jnp.float32))
    got = tint.map_view_pred_affine(pred_t, *grid, M, t, shape, vp)
    slabbed = tint.map_view_pred_affine(pred_t, *grid, M, t, shape, vp,
                                        x_slab=5)
    assert got.dtype == torch.bfloat16 and got.shape == shape + (4,)
    assert (got.float().numpy() == want).all(-1).mean() >= 0.9999
    np.testing.assert_array_equal(slabbed.float().numpy(),
                                  got.float().numpy())
    # voxels that map outside the stack take the one-hot background
    assert (got.float().numpy()[..., 0] == 1.0).any()


def test_accum_view_pred_affine_matches_map_then_accumulate():
    """In-place slab accumulation equals map-then-accumulate within 1e-6,
    its argmax side output equals the map's argmax, and both agree with
    the JAX package's accum_view_pred_affine."""
    pred, grid, M, t, shape, vp = _remap_case(3)
    pred_t = _t(pred).to(torch.bfloat16)
    rng = np.random.RandomState(5)
    accum0 = rng.rand(*shape, 4).astype(np.float32)
    w = np.array([0.5, 1.5, 1.0, 2.0], np.float32)
    mapped = tint.map_view_pred_affine(pred_t, *grid, M, t, shape, vp
                                       ).float()
    want = _t(accum0) + _t(w) * mapped
    for x_slab in (None, 4):
        accum = _t(accum0.copy())
        side = tint.accum_view_pred_affine(pred_t, *grid, M, t, accum, w, vp,
                                           want_argmax=True, x_slab=x_slab)
        np.testing.assert_allclose(accum.numpy(), want.numpy(), atol=1e-6)
        np.testing.assert_array_equal(side.numpy(),
                                      mapped.argmax(-1).to(torch.uint8)
                                      .numpy())
    j_accum, j_side = jint.accum_view_pred_affine(
        jnp.asarray(pred, jnp.bfloat16), *grid, jnp.asarray(M),
        jnp.asarray(t), jnp.asarray(accum0), jnp.asarray(w), vp,
        want_argmax=True)
    assert (np.abs(accum.numpy() - np.asarray(j_accum)) <= 1e-6
            ).all(-1).mean() >= 0.9999
    assert (side.numpy() == np.asarray(j_side)).mean() >= 0.9999
    assert tint.accum_view_pred_affine(pred_t, *grid, M, t, accum, w,
                                       vp) is None
