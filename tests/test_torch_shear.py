"""The port's shear resampler against the JAX package's.

Planner and geometry copies must be identical; the plain shear pass must
match the JAX take and Pallas (interpret mode) executors; the torch
`shear_resample` must match the JAX one on the same inputs."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiplanarunet_tpu.ops import geometry as jgeo
from multiplanarunet_tpu.ops import shear as jshear
from multiplanarunet_tpu_torch.ops import geometry as tgeo
from multiplanarunet_tpu_torch.ops import shear as tshear
from multiplanarunet_tpu_torch.ops import shear_plan as tplan
from multiplanarunet_tpu_torch.ops.shear_pass import (
    shear_pass,
    shear_pass_reference,
)
from tests.torch_projects import torch_threads  # noqa: F401


def _random_affine(rng, scale_aniso=True):
    A = rng.randn(3, 3)
    Q, _ = np.linalg.qr(A)
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    s = np.diag(1.0 + (rng.rand(3) * 0.8 - 0.3)) if scale_aniso else np.eye(3)
    return Q @ s


def _op_tuple(o):
    return (o.m, o.q, o.alpha, o.beta, o.gamma, o.in_lo, o.in_extent,
            o.out_lo, o.out_extent, o.q_lo)


def _assert_same_plan(p_jax, p_torch):
    assert p_torch.valid == p_jax.valid
    assert p_torch.perm == p_jax.perm
    assert p_torch.out_perm == p_jax.out_perm
    assert p_torch.src_shape == p_jax.src_shape
    assert p_torch.out_shape == p_jax.out_shape
    assert p_torch.stages == p_jax.stages
    assert ([_op_tuple(o) for o in p_torch.ops]
            == [_op_tuple(o) for o in p_jax.ops])


def _bench_geometry():
    """The 256^3, 6-view geometry of bench.py (span 255, same+20 planes,
    adaptive chunk padding as the predictor pads)."""
    dim, n_valid = 256, 276
    steps = -(-n_valid // 48)
    P_pad = steps * 2 * (-(-n_valid // (2 * steps)))
    span = 255.0
    sample_res = span / (dim - 1)
    bounds = (span + 20 * sample_res) / 2
    offsets = np.linspace(-bounds, bounds, n_valid).astype(np.float32)
    g0 = float(-(span // 2))
    g_step = (-2.0 * g0) / (dim - 1)
    views = jgeo.sample_random_views_with_angle_restriction(
        6, 60, rng=np.random.RandomState(42))
    origin, spacing, _ = jgeo.voxel_axes_origin_spacing((256,) * 3, np.eye(4))
    A = np.eye(3)
    center = A @ ((np.array([256] * 3) - 1) / 2.0)
    for view in views:
        basis = jgeo.plane_basis(view)
        inv_b = np.linalg.inv(basis.astype(np.float64))
        M = (inv_b @ A).astype(np.float32)
        t = (-inv_b @ center).astype(np.float32)
        yield dict(basis=basis, origin=origin, spacing=spacing, g0=g0,
                   g_step=g_step, o0=float(offsets[0]),
                   o_step=float(offsets[1] - offsets[0]), M=M, t=t,
                   P_pad=P_pad)


# ------------------------------------------------------------------ planner
def test_planner_random_affines_identical():
    rng = np.random.RandomState(0)
    for _ in range(12):
        N = _random_affine(rng)
        c = rng.randn(3) * 4
        src = tuple(int(s) for s in rng.randint(8, 40, 3))
        out = tuple(int(s) for s in rng.randint(8, 40, 3))
        _assert_same_plan(jshear.plan_affine_resample(N, c, src, out),
                          tplan.plan_affine_resample(N, c, src, out))
    # numerically singular: both report invalid
    sing = np.array([[1.0, 0, 0], [1.0, 0, 0], [0, 0, 1.0]])
    assert not jshear.plan_affine_resample(sing, np.zeros(3), (8,) * 3,
                                           (8,) * 3).valid
    assert not tplan.plan_affine_resample(sing, np.zeros(3), (8,) * 3,
                                          (8,) * 3).valid


def test_planner_full_size_bench_geometry_identical():
    for g in _bench_geometry():
        args = (g["basis"], np.eye(3), g["origin"], g["spacing"], g["g0"],
                g["g_step"], g["o0"], g["o_step"], (256,) * 3, 256,
                g["P_pad"])
        pj, (Nj, cj) = jshear.plan_plane_stack(*args)
        pt, (Nt, ct) = tplan.plan_plane_stack(*args)
        _assert_same_plan(pj, pt)
        np.testing.assert_array_equal(Nj, Nt)
        np.testing.assert_array_equal(cj, ct)
        rargs = (g["M"], g["t"], g["g0"], g["g_step"], g["o0"], g["o_step"],
                 (256, 256, g["P_pad"]), (256,) * 3)
        rj, (Nj, cj) = jshear.plan_view_remap(*rargs)
        rt, (Nt, ct) = tplan.plan_view_remap(*rargs)
        _assert_same_plan(rj, rt)
        np.testing.assert_array_equal(Nj, Nt)
        np.testing.assert_array_equal(cj, ct)


def test_factor_affine_identical():
    rng = np.random.RandomState(1)
    for _ in range(10):
        N = _random_affine(rng)
        pj, oj = jshear.factor_affine(N)
        pt, ot = tplan.factor_affine(N)
        assert pj == pt
        assert ([(o.m, o.q, o.alpha, o.beta) for o in oj]
                == [(o.m, o.q, o.alpha, o.beta) for o in ot])
        np.testing.assert_array_equal(jshear._compose(oj)[0],
                                      tplan._compose(ot)[0])


# ----------------------------------------------------------------- geometry
def test_geometry_identical():
    rng = np.random.RandomState(2)
    for _ in range(5):
        axis = rng.randn(3)
        ang = float(rng.rand() * 360)
        np.testing.assert_array_equal(jgeo.rotation_matrix(axis, ang),
                                      tgeo.rotation_matrix(axis, ang))
        v1, v2 = rng.randn(3), rng.randn(3)
        assert jgeo.get_angle_deg(v1, v2) == tgeo.get_angle_deg(v1, v2)
        np.testing.assert_array_equal(jgeo.plane_basis(v1),
                                      tgeo.plane_basis(v1))
        noise = rng.randn(3) * 0.1
        np.testing.assert_array_equal(jgeo.plane_basis(v1, noise_sd=noise),
                                      tgeo.plane_basis(v1, noise_sd=noise))
    for affine in (np.eye(4), np.diag([-1.0, 1.0, -1.0, 1.0]),
                   np.diag([1.0, 0.8, 1.2, 1.0])):
        affine = affine.copy()
        affine[:3, :3] = jgeo.rotation_matrix([0, 0, 1], 25) @ affine[:3, :3]
        shape = (20, 24, 18)
        for a, b in zip(jgeo.voxel_axes_origin_spacing(shape, affine),
                        tgeo.voxel_axes_origin_spacing(shape, affine)):
            np.testing.assert_array_equal(a, b)
        ja = jgeo.get_voxel_axes_real_space(shape, affine)
        ta = tgeo.get_voxel_axes_real_space(shape, affine)
        for a, b in zip(ja, ta):
            np.testing.assert_array_equal(a, b)

        class _Img:
            pass
        img = _Img()
        img.affine, img.shape = affine, shape
        np.testing.assert_array_equal(jgeo.get_pix_dim(img),
                                      tgeo.get_pix_dim(img))
        assert (jgeo.get_bounding_sphere_real_radius(img)
                == tgeo.get_bounding_sphere_real_radius(img))
        assert (jgeo.get_maximum_real_dim(img)
                == tgeo.get_maximum_real_dim(img))
    for seed in (0, 42):
        np.testing.assert_array_equal(
            jgeo.get_random_views(5, rng=np.random.RandomState(seed)),
            tgeo.get_random_views(5, rng=np.random.RandomState(seed)))
        np.testing.assert_array_equal(
            jgeo.sample_random_views_with_angle_restriction(
                6, 60, rng=np.random.RandomState(seed)),
            tgeo.sample_random_views_with_angle_restriction(
                6, 60, rng=np.random.RandomState(seed)))


# --------------------------------------------------------------------- pass
def _pass_inputs(seed, shape=(20, 14, 10), C=2):
    rng = np.random.RandomState(seed)
    N = _random_affine(rng)
    c = np.array([10.0, 7.0, 5.0]) - N @ np.array([9.0, 6.0, 4.0])
    plan = tplan.plan_affine_resample(N, c, shape, (16, 12, 14))
    assert plan.valid
    src = rng.rand(*shape, C).astype(np.float32)
    return src, plan


@pytest.mark.parametrize("impl", ["take", "pallas"])
@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_plain_pass_matches_jax_executors(method, impl):
    """Every pass of a random plan, fed the same input, through the port's
    plain version and the JAX executor (Pallas in interpret mode on the
    CPU, as tests/test_shear.py runs it). atol 5e-4 as there: the JAX
    executors may contract the position arithmetic differently."""
    src, plan = _pass_inputs(11)
    A = np.transpose(src, plan.perm + (3,))
    for op in plan.ops:
        A = np.ascontiguousarray(A)
        run = jax.jit(lambda x: jshear._pass_jnp(x, op, method, impl=impl))
        want = np.array(run(jnp.asarray(A)))
        got = shear_pass(torch.from_numpy(A), op, method).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=5e-4)
        A = want


def test_plain_pass_rejects_what_kernel_does_not_take():
    src, plan = _pass_inputs(3)
    A = torch.from_numpy(np.ascontiguousarray(
        np.transpose(src, plan.perm + (3,))))
    op = plan.ops[0]
    with pytest.raises(ValueError, match="methods"):
        shear_pass(A, op, "nearest")
    with pytest.raises(ValueError, match="contiguous"):
        shear_pass(A.transpose(0, 1), op, "linear")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        shear_pass(A.double(), op, "linear")
    with pytest.raises(ValueError, match="rank-4"):
        shear_pass(A[..., 0], op, "linear")
    with pytest.raises(ValueError, match="planned"):
        shear_pass(A.narrow(op.m, 0, A.shape[op.m] - 1).contiguous(), op,
                   "linear")


def test_plain_pass_bf16_rounds_once_from_f32():
    """bf16 in, f32 tap sum, one rounding on the way out."""
    src, plan = _pass_inputs(5)
    A = torch.from_numpy(np.ascontiguousarray(
        np.transpose(src, plan.perm + (3,)))).to(torch.bfloat16)
    op = plan.ops[0]
    got = shear_pass_reference(A, op, "cubic")
    assert got.dtype == torch.bfloat16
    want = shear_pass_reference(A.float(), op, "cubic").to(torch.bfloat16)
    assert torch.equal(got, want)


# ----------------------------------------------------------- full resample
_JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _both(src, plan, fill, **kw):
    """(JAX result as f32 numpy, torch result) of shear_resample."""
    jkw = {k: _JAX_DTYPE.get(v, v) if isinstance(v, torch.dtype) else v
           for k, v in kw.items()}
    run = jax.jit(lambda x: jshear.shear_resample(x, plan, fill, **jkw))
    want = np.asarray(run(jnp.asarray(src))).astype(np.float32)
    got = tshear.shear_resample(torch.from_numpy(src), plan, fill, **kw)
    return want, got


def test_resample_identity_exact():
    rng = np.random.RandomState(1)
    src = rng.rand(12, 14, 10, 2).astype(np.float32)
    plan = tplan.plan_affine_resample(np.eye(3), np.zeros(3), src.shape[:3],
                                      src.shape[:3])
    want, got = _both(src, plan, [9.0, 9.0])
    np.testing.assert_allclose(got.numpy(), src, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_resample_translation_fill():
    rng = np.random.RandomState(2)
    src = rng.rand(10, 10, 10, 1).astype(np.float32)
    plan = tplan.plan_affine_resample(np.eye(3), np.array([4.0, 0.0, 0.0]),
                                      src.shape[:3], src.shape[:3])
    want, got = _both(src, plan, [7.0])
    got = got.numpy()
    np.testing.assert_allclose(got[:6], src[4:], atol=1e-6)
    np.testing.assert_allclose(got[6:], 7.0)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_resample_random_affine_exact_bounds(method):
    rng = np.random.RandomState(4)
    src = rng.rand(16, 14, 12, 3).astype(np.float32)
    for _ in range(2):
        N = _random_affine(rng)
        c = np.array([8.0, 7.0, 6.0]) - N @ np.array([7.0, 7.0, 7.0])
        plan = tplan.plan_affine_resample(N, c, src.shape[:3], (14, 15, 13))
        fill = np.array([1.0, 0.0, -2.0], np.float32)
        want, got = _both(src, plan, fill, method=method,
                          exact_bounds=(N, c))
        # f32 throughout; differences come only from position rounding
        np.testing.assert_allclose(got.numpy(), want, atol=5e-4)


def test_resample_bucket_padded_bounds_shape():
    """A source zero-padded past its true extent (the sampler's bucket):
    the pad holds no data and the inside rule uses the true shape."""
    rng = np.random.RandomState(6)
    true = (13, 11, 9)
    src = np.zeros((16, 16, 16, 2), np.float32)
    src[:13, :11, :9] = rng.rand(*true, 2)
    N = _random_affine(rng)
    c = np.array([6.0, 5.0, 4.0]) - N @ np.array([6.0, 6.0, 6.0])
    plan = tplan.plan_affine_resample(N, c, src.shape[:3], (12, 12, 12))
    fill = np.array([0.5, -0.5], np.float32)
    want, got = _both(src, plan, fill, method="cubic",
                      exact_bounds=(N, c, true))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4)


def test_resample_bf16_compute_f32_out():
    """The remap's mode: bf16 passes, f32 epilogue. JAX's take form
    multiplies and sums the taps in bf16, the port in f32 with one
    rounding per pass, so the two differ by a few bf16 ulps of the unit
    range: atol 2e-2 (bf16 has 8 bits of mantissa, ulp(1) = 2^-7 ~ 7.8e-3,
    and six passes of bf16 tap products add about two of them)."""
    rng = np.random.RandomState(7)
    src = rng.rand(20, 24, 18, 4).astype(np.float32)
    src /= src.sum(-1, keepdims=True)
    fill = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    N = _random_affine(rng)
    c = np.array([9.0, 11.0, 8.0]) - N @ (np.array([22, 20, 21]) / 2.0)
    plan = tplan.plan_affine_resample(N, c, src.shape[:3], (22, 20, 21))
    want, got = _both(src, plan, fill, method="linear",
                      compute_dtype=torch.bfloat16, out_dtype=torch.float32,
                      exact_bounds=(N, c))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2)
    f32 = tshear.shear_resample(torch.from_numpy(src), plan, fill,
                                method="linear", exact_bounds=(N, c))
    np.testing.assert_allclose(got.numpy(), f32.numpy(), atol=2e-2)


def test_exact_inside_mask_identical():
    rng = np.random.RandomState(8)
    for _ in range(6):
        N = _random_affine(rng) * (1.0 + rng.rand())
        out_shape = tuple(int(s) for s in rng.randint(10, 30, 3))
        src_shape = tuple(int(s) for s in rng.randint(10, 30, 3))
        c = np.asarray(src_shape) / 2.0 - N @ (np.asarray(out_shape) / 2.0)
        want = np.asarray(jshear.exact_inside_mask(N, c, src_shape,
                                                   out_shape))
        got = tshear.exact_inside_mask(N, c, src_shape, out_shape,
                                       torch.device("cpu")).numpy()
        assert 0 < got.sum() < got.size
        np.testing.assert_array_equal(got, want)
