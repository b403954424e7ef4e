"""The port's 3D box geometry, box gathers, box scatter and Elastic3D
against the JAX package's, on the same seeded numpy inputs: the geometry
bit-equal under one np.random seed, sampled images within 1e-5, nearest
labels equal on >= 0.9999 of voxels, the scatter's sums within 1e-5, and
the 3D elastic warp on JAX's own noise fields."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiplanarunet_tpu.augmentation.augmenters import Elastic3D as JElastic3D
from multiplanarunet_tpu.ops import elastic as jelastic
from multiplanarunet_tpu.ops import geometry as jgeo
from multiplanarunet_tpu.ops import interp as jinterp
from multiplanarunet_tpu_torch.augmentation.augmenters import Elastic3D
from multiplanarunet_tpu_torch.ops import elastic as telastic
from multiplanarunet_tpu_torch.ops import geometry as tgeo
from multiplanarunet_tpu_torch.ops import interp as tinterp
from tests.torch_projects import torch_threads  # noqa: F401


SHAPE = (20, 22, 18)
D = 12  # box side in voxels
BOX = 15.0  # box side in mm


def _image_geometry(seed):
    """(origin, spacing, rot) of an oblique, anisotropic image of SHAPE,
    from the shared geometry helper."""
    rng = np.random.RandomState(seed)
    rot = jgeo.rotation_matrix(rng.randn(3), 20.0)
    affine = np.eye(4)
    affine[:3, :3] = rot @ np.diag([1.1, 0.9, 1.2])
    origin, spacing, grid_rot = tgeo.voxel_axes_origin_spacing(SHAPE, affine)
    return (np.asarray(origin, np.float32), np.asarray(spacing, np.float32),
            np.asarray(grid_rot, np.float32))


def _boxes(seed, n, noise_sd=0.2):
    """n corners (from random_box_placement) and rotations."""
    np.random.seed(seed)
    corners = np.stack([jgeo.random_box_placement((22.0, 20.0, 21.0), BOX)
                        for _ in range(n)]).astype(np.float32)
    rots = np.stack([jgeo.random_box_rotation(noise_sd)
                     for _ in range(n)]).astype(np.float32)
    rots[0] = np.eye(3)  # the base tiling's identity box
    return corners, rots


def test_box_geometry_bit_equal_under_one_seed():
    """random_box_placement, random_box_rotation (the same np.random draws
    in the same order), sample_box_grid with and without a rotation and
    its axes, get_voxel_grid_real_space, mgrid_to_points and
    points_to_mgrid."""
    for seed in (0, 1, 2):
        draws = {}
        for name, geo in (("jax", jgeo), ("port", tgeo)):
            np.random.seed(seed)
            draws[name] = [geo.random_box_placement((30.0, 8.0, 25.5), 12.5),
                           geo.random_box_rotation(0.3),
                           geo.random_box_placement((40.0, 41.0, 2.0), 30.0),
                           np.random.rand()]  # the stream continues alike
        for a, b in zip(draws["jax"], draws["port"]):
            np.testing.assert_array_equal(a, b)
    rot = jgeo.random_box_rotation(0.5, rng=np.random.RandomState(4))
    for rot_mat in (None, rot):
        want = jgeo.sample_box_grid((-3.1, 2.5, 0.7), 9, 14.0, rot_mat,
                                    return_axes=True)
        got = tgeo.sample_box_grid((-3.1, 2.5, 0.7), 9, 14.0, rot_mat,
                                   return_axes=True)
        for a, b in zip((want[0],) + want[1] + (want[2],),
                        (got[0],) + got[1] + (got[2],)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    affine = np.diag([1.1, 0.9, 1.3, 1.0])
    affine[:3, :3] = jgeo.rotation_matrix((1.0, 2.0, 0.5), 17.0) @ \
        affine[:3, :3]
    grid = tgeo.get_voxel_grid_real_space((5, 6, 7, 2), affine)
    np.testing.assert_array_equal(
        grid, jgeo.get_voxel_grid_real_space((5, 6, 7, 2), affine))
    pts = tgeo.mgrid_to_points(grid)
    np.testing.assert_array_equal(pts, jgeo.mgrid_to_points(grid))
    np.testing.assert_array_equal(tgeo.points_to_mgrid(pts, (5, 6, 7)),
                                  jgeo.points_to_mgrid(pts, (5, 6, 7)))


def test_sample_box_matches_jax():
    """Linear image boxes within 1e-5 and nearest label boxes equal on >=
    0.9999 of voxels, for identity and rotated boxes, with the per-channel
    fill outside the valid extent."""
    rng = np.random.RandomState(0)
    vol = rng.rand(*SHAPE, 2).astype(np.float32) * 4.0
    labs = np.floor(vol[..., :1]).astype(np.float32)
    origin, spacing, rot = _image_geometry(1)
    corners, rots = _boxes(2, 3)
    fill = np.array([0.3, -0.2], np.float32)
    valid = (19, 22, 17)
    equal = []
    for corner, box_rot in zip(corners, rots):
        want = jinterp.sample_box(
            jnp.asarray(vol), jnp.asarray(origin), jnp.asarray(spacing),
            jnp.asarray(rot), jnp.asarray(corner), BOX, jnp.asarray(box_rot),
            D, jnp.asarray(fill), valid_shape=jnp.asarray(valid))
        got = tinterp.sample_box(torch.from_numpy(vol), origin, spacing, rot,
                                 corner, BOX, box_rot, D, fill,
                                 valid_shape=valid)
        assert got.shape == (D, D, D, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        want = jinterp.sample_box(
            jnp.asarray(labs), jnp.asarray(origin), jnp.asarray(spacing),
            jnp.asarray(rot), jnp.asarray(corner), BOX, jnp.asarray(box_rot),
            D, 0.0, method="nearest", valid_shape=jnp.asarray(valid))
        got = tinterp.sample_box(torch.from_numpy(labs), origin, spacing,
                                 rot, corner, BOX, box_rot, D, 0.0,
                                 method="nearest", valid_shape=valid)
        equal.append((got.numpy() == np.asarray(want)).mean())
    assert min(equal) >= 0.9999, equal


def test_sample_box_batch_pool_matches_jax():
    """B boxes from B pool slots (a slot read twice) in one gather against
    the JAX package's vmapped pool gather: images within 1e-5, nearest
    labels equal on >= 0.9999 of voxels."""
    rng = np.random.RandomState(3)
    pool = rng.rand(3, *SHAPE, 2).astype(np.float32) * 3.0
    lab_pool = np.floor(pool[..., :1])
    slots = np.array([2, 0, 2, 1], np.int32)
    geos = [_image_geometry(s) for s in (4, 5, 6)]
    origins = np.stack([geos[s][0] for s in slots])
    spacings = np.stack([geos[s][1] for s in slots])
    rots = np.stack([geos[s][2] for s in slots])
    corners, box_rots = _boxes(7, len(slots))
    fills = rng.rand(len(slots), 2).astype(np.float32)
    valid = np.array([SHAPE, (18, 22, 18), SHAPE, (20, 20, 16)],
                     np.int32)[slots]
    args = (slots, origins, spacings, rots, corners, box_rots)
    want = jinterp.sample_box_batch_pool(
        jnp.asarray(pool), *map(jnp.asarray, args), BOX, D,
        jnp.asarray(fills), valid_shapes=jnp.asarray(valid))
    got = tinterp.sample_box_batch_pool(torch.from_numpy(pool), *args, BOX,
                                        D, fills, valid_shapes=valid)
    assert got.shape == (len(slots), D, D, D, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    bg = np.array([[0.0], [1.0], [0.0], [2.0]], np.float32)
    want = jinterp.sample_box_batch_pool(
        jnp.asarray(lab_pool), *map(jnp.asarray, args), BOX, D,
        jnp.asarray(bg), method="nearest", valid_shapes=jnp.asarray(valid))
    got = tinterp.sample_box_batch_pool(
        torch.from_numpy(lab_pool), *args, BOX, D, bg, method="nearest",
        valid_shapes=valid)
    assert (got.numpy() == np.asarray(want)).mean() >= 0.9999


def test_scatter_box_pred_matches_jax():
    """Three boxes (one identity, two rotated) added onto their nearest
    voxels by one port call and by three JAX calls: sums within 1e-5,
    voxels outside the valid extent dropped, the same voxels touched."""
    rng = np.random.RandomState(8)
    origin, spacing, rot = _image_geometry(9)
    corners, rots = _boxes(10, 3)
    invs = np.linalg.inv(rots.astype(np.float64)).astype(np.float32)
    preds = rng.rand(3, D, D, D, 3).astype(np.float32)
    valid = (19, 21, 18)
    want = jnp.zeros(SHAPE + (3,), jnp.float32)
    for b in range(3):
        want = jinterp.scatter_box_pred(
            want, jnp.asarray(preds[b]), jnp.asarray(corners[b]),
            jnp.float32(BOX), jnp.asarray(invs[b]), jnp.asarray(rot),
            jnp.asarray(origin), jnp.asarray(spacing), D,
            jnp.asarray(valid, jnp.float32))
    want = np.asarray(want)
    acc = torch.zeros(SHAPE + (3,))
    got = tinterp.scatter_box_pred(acc, torch.from_numpy(preds), corners,
                                   BOX, invs, rot, origin, spacing, D, valid)
    assert got is acc
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(got.numpy() != 0, want != 0)
    assert not got[19:].any() and not got[:, 21:].any()
    assert 0.1 < (want.sum(-1) > 0).mean() < 1.0


def test_elastic_deform_3d_on_jax_fields_matches_jax():
    """elastic_deform_3d_fields fed the three noise fields the JAX warp
    draws from its key: images within 1e-5, labels equal on >= 0.9999 of
    voxels; samples with apply False pass through unchanged."""
    B, d, C = 3, 16, 2
    rng = np.random.RandomState(11)
    images = rng.randn(B, d, d, d, C).astype(np.float32)
    labels = rng.randint(0, 4, (B, d, d, d)).astype(np.float32)
    alphas = np.array([300.0, 450.0, 120.0], np.float32)
    sigmas = np.array([12.0, 25.0, 14.5], np.float32)
    apply = np.array([True, False, True])
    bg = rng.rand(B, C).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want_x, want_y = jelastic.elastic_deform_3d_batch(
        key, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(alphas),
        jnp.asarray(sigmas), jnp.asarray(apply), jnp.asarray(bg))
    fields = [np.array(jax.random.uniform(k, (B, d, d, d), minval=-1.0,
                                            maxval=1.0))
              for k in jax.random.split(key, 3)]
    got_x, got_y = telastic.elastic_deform_3d_fields(
        torch.from_numpy(images), torch.from_numpy(labels),
        *map(torch.from_numpy, fields), alphas, sigmas, apply, bg)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=1e-5)
    assert (got_y.numpy() == np.asarray(want_y)).mean() >= 0.9999
    np.testing.assert_array_equal(got_x[1].numpy(), images[1])
    assert not np.array_equal(got_x[0].numpy(), images[0])


def test_elastic3d_augmenter_draws_and_weights_match_jax():
    """Elastic3D draws apply_mask, alphas and sigmas from its numpy stream
    in the JAX order with the JAX batch keys (fold_in of PRNGKey(seed) and
    the batch count), replaces the weights of the augmented boxes and
    deforms them as the JAX augmenter does: images within 1e-5, labels
    equal on >= 0.9999 of voxels (the tolerances of its fields above)."""
    kw = dict(alpha=[0, 450], sigma=[12, 25], apply_prob=0.5, seed=3)
    jaug, taug = JElastic3D(**kw), Elastic3D(**kw)
    for _ in range(2):
        want = jaug.draw_batch_params(6)
        got = taug.draw_batch_params(6)
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        for a, b in zip(want[1:], got[1:]):
            np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(12)
    x = rng.randn(4, 8, 8, 8, 1).astype(np.float32)
    y = rng.randint(0, 3, (4, 8, 8, 8, 1)).astype(np.int32)
    w = np.ones(4, np.float32)
    jx, jy, jw = jaug(jnp.asarray(x), jnp.asarray(y), w, np.zeros((4, 1)))
    tx, ty, tw = taug(torch.from_numpy(x), torch.from_numpy(y), w,
                      np.zeros((4, 1)))
    np.testing.assert_array_equal(tw, jw)
    assert tx.shape == x.shape and ty.shape == x.shape[:-1]
    assert ty.dtype == torch.float32 and torch.isfinite(tx).all()
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    assert (ty.numpy() == np.asarray(jy)).mean() >= 0.9999
    assert str(taug) == str(jaug)


@pytest.mark.parametrize("noise_sd", [0.0, 0.1])
def test_box_points_identity_keeps_jax_center_rounding(noise_sd):
    """The box points take the center round trip (p - c) @ R.T + c even
    for an identity R, as the JAX package does; the port's identity boxes
    therefore equal JAX's bit for bit, not only the plain linspace."""
    corners, rots = _boxes(13, 2, noise_sd=noise_sd or 1e-9)
    vol = np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE + (1,))
    origin, spacing, rot = _image_geometry(14)
    for corner, box_rot in zip(corners, rots):
        want = jinterp.sample_box(
            jnp.asarray(vol), jnp.asarray(origin), jnp.asarray(spacing),
            jnp.asarray(rot), jnp.asarray(corner), BOX, jnp.asarray(box_rot),
            D, 0.0, method="nearest", valid_shape=jnp.asarray(SHAPE))
        got = tinterp.sample_box(torch.from_numpy(vol), origin, spacing, rot,
                                 corner, BOX, box_rot, D, 0.0,
                                 method="nearest", valid_shape=SHAPE)
        assert (got.numpy() == np.asarray(want)).mean() >= 0.9999
