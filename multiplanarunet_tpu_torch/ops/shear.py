"""Shear-decomposed affine resampling, executed with torch.

Port of `shear_resample`, `exact_inside_mask` and `shear_resample_np` of
`multiplanarunet_tpu/ops/shear.py`. A plan (`ops.shear_plan`, whose
planner names this module re-exports from the JAX module's path) factors
the affine index map into six single-axis passes; each runs through
`ops.shear_pass.shear_pass` (the CUDA kernel on the card). A validity
channel rides along so reads outside the stored data can be detected and
renormalised; the epilogue replaces outside voxels with the fill vector.
`shear_resample_np` is the whole resample in float64 numpy, independent
of the kernel and of its plain torch version: the host-side reference.
"""

from __future__ import annotations

import numpy as np
import torch

from multiplanarunet_tpu_torch.ops.shear_pass import shear_pass
from multiplanarunet_tpu_torch.ops.shear_plan import (  # noqa: F401
    ShearPlan,
    factor_affine,
    plan_affine_resample,
    plan_plane_stack,
    plan_view_remap,
)


def exact_inside_mask(N, c, src_shape, out_shape, device):
    """Boolean (X, Y, Z) inside-mask in closed form: a voxel is inside iff
    N v + c lies within [0, n-1] on every source axis. Evaluated in float32
    in the JAX package's order, which decides the boundary voxels."""
    N = np.asarray(N, np.float64)
    c = np.asarray(c, np.float64)
    X, Y, Z = (int(s) for s in out_shape)
    ii = torch.arange(X, dtype=torch.float32, device=device)[:, None, None]
    jj = torch.arange(Y, dtype=torch.float32, device=device)[None, :, None]
    kk = torch.arange(Z, dtype=torch.float32, device=device)[None, None, :]
    inside = torch.ones((X, Y, Z), dtype=torch.bool, device=device)
    for a in range(3):
        r = (ii * float(np.float32(N[a, 0])) + jj * float(np.float32(N[a, 1]))
             + kk * float(np.float32(N[a, 2])) + float(np.float32(c[a])))
        inside &= (r >= 0.0) & (r <= float(np.float32(src_shape[a] - 1)))
    return inside


def shear_resample(src, plan, fill, method="linear",
                   compute_dtype=torch.float32, exact_bounds=None,
                   out_dtype=None):
    """Execute a ShearPlan on src's device.

    src: (S0, S1, S2, C). Returns plan.out_shape + (C,) in out_dtype
    (default compute_dtype) with `fill` (C,) where the map lands outside
    src. The passes run in compute_dtype (bf16 halves their bandwidth);
    the validity division runs in out_dtype.

    exact_bounds: optional (N, c) or (N, c, bounds_shape) of the planned
    affine; when given, the inside/outside decision uses the closed-form
    exact rule instead of the carried validity channel, which erodes about
    one voxel per pass at volume borders. bounds_shape overrides src's
    shape in that rule and marks src's samples beyond it (bucket padding)
    as holding no data."""
    C = src.shape[-1]
    out_dtype = out_dtype or compute_dtype
    A = src.to(compute_dtype)
    valid0 = torch.ones(A.shape[:3] + (1,), dtype=compute_dtype,
                        device=A.device)
    if exact_bounds is not None and len(exact_bounds) > 2:
        bshape = tuple(int(s) for s in exact_bounds[2])
        if bshape != tuple(src.shape[:3]):
            # src is bucket-padded beyond its true extent: zero BOTH data
            # and validity there, so taps reaching past the true upper edge
            # renormalise out through the final validity division (on the
            # remap side the padded tail planes hold U-Net outputs of padded
            # inputs, which must not blend in)
            for a, (size, lim) in enumerate(zip(src.shape[:3], bshape)):
                if size != lim:
                    keep = (torch.arange(size, device=A.device) < lim)
                    valid0 = valid0 * keep.to(compute_dtype).reshape(
                        tuple(size if i == a else 1 for i in range(3))
                        + (1,))
            A = A * valid0
    A = torch.cat([A, valid0], dim=-1)
    A = A.permute(*plan.perm, 3).contiguous()
    for op in plan.ops:
        A = shear_pass(A, op, method)
    if tuple(plan.out_perm) != (0, 1, 2):
        inv = tuple(int(i) for i in np.argsort(plan.out_perm))
        A = A.permute(*inv, 3)
    data = A[..., :C].to(out_dtype)
    valid = A[..., C].to(out_dtype)
    if exact_bounds is not None:
        N, c = exact_bounds[0], exact_bounds[1]
        bshape = exact_bounds[2] if len(exact_bounds) > 2 else plan.src_shape
        ok = exact_inside_mask(N, c, bshape, plan.out_shape, A.device)
    else:
        ok = valid > 0.5
    # Undo border darkening (blending with zero pads) by dividing by the
    # carried validity; clamp so exact-inside voxels with tiny validity
    # (deep shear corners) stay bounded
    safe = valid.clamp_min(0.05)[..., None]
    fill = torch.as_tensor(np.asarray(fill, np.float32), device=A.device
                           ).to(out_dtype)
    return torch.where(ok[..., None], data / safe, fill)


# ---------------------------------------------------------------- numpy twin
def _tap_parts_np(pos, method):
    """[(index int64, weight float64 or None)] taps at float64 positions
    (nearest: one tap at the rounded position; linear: 2; cubic:
    Catmull-Rom's 4)."""
    if method == "nearest":
        return [(np.round(pos).astype(np.int64), None)]
    i0f = np.floor(pos)
    f = pos - i0f
    idx0 = i0f.astype(np.int64)
    if method == "linear":
        return [(idx0, 1.0 - f), (idx0 + 1, f)]
    if method != "cubic":
        raise ValueError(f"unknown method {method!r}")
    f2, f3 = f * f, f * f * f
    return [
        (idx0 - 1, -0.5 * f + f2 - 0.5 * f3),
        (idx0, 1.0 - 2.5 * f2 + 1.5 * f3),
        (idx0 + 1, 0.5 * f + 2.0 * f2 - 1.5 * f3),
        (idx0 + 2, -0.5 * f2 + 0.5 * f3),
    ]


def _pass_np(A, op, method="linear"):
    """One elementary pass over the float64 stage A (rank 4, channels
    last) in numpy: taps outside [0, L_in) read nothing."""
    m, q = op.m, op.q
    L_out, L_in = op.out_extent, op.in_extent
    t = np.arange(L_out, dtype=np.float64)
    pos = op.alpha * (t + op.out_lo) + op.gamma - op.in_lo
    if q is not None:
        b = np.arange(A.shape[q], dtype=np.float64) + op.q_lo
        pos = pos[None, :] + op.beta * b[:, None]
    else:
        pos = pos[None, :]

    def lift(x):
        shape = [1, 1, 1, 1]
        shape[m] = L_out
        if q is not None:
            shape[q] = x.shape[0]
            if q > m:
                x = x.T
        return x.reshape(shape)

    tgt = list(A.shape)
    tgt[m] = L_out
    out = None
    for idx, w in _tap_parts_np(pos, method):
        valid = (idx >= 0) & (idx < L_in)
        idx_l = lift(np.clip(idx, 0, L_in - 1))
        term = np.take_along_axis(A, np.broadcast_to(idx_l, tgt), axis=m)
        term = term * lift(valid)
        if w is not None:
            term = term * lift(w)
        out = term if out is None else out + term
    return out


def shear_resample_np(src, plan, fill, method="linear", exact_bounds=None):
    """The float64 numpy reference of `shear_resample`: src (S0, S1, S2,
    C) array through every pass of `plan` with the validity channel, the
    validity division (clamped at 0.05) and `fill` (C,) outside, where
    outside is the exact closed-form rule when exact_bounds ((N, c) or
    (N, c, bounds_shape)) is given, else validity <= 0.5. Returns
    plan.out_shape + (C,) float64."""
    C = src.shape[-1]
    A = np.concatenate([np.asarray(src, np.float64),
                        np.ones(src.shape[:3] + (1,), np.float64)], axis=-1)
    A = np.transpose(A, tuple(plan.perm) + (3,))
    for op in plan.ops:
        A = _pass_np(A, op, method)
    if tuple(plan.out_perm) != (0, 1, 2):
        A = np.transpose(A, tuple(np.argsort(plan.out_perm)) + (3,))
    data, valid = A[..., :C], A[..., C]
    if exact_bounds is not None:
        N, c = exact_bounds[0], exact_bounds[1]
        bshape = exact_bounds[2] if len(exact_bounds) > 2 else plan.src_shape
        ii, jj, kk = np.meshgrid(*[np.arange(s) for s in plan.out_shape],
                                 indexing="ij")
        pts = (np.stack([ii, jj, kk], -1).astype(np.float64)
               @ np.asarray(N, np.float64).T + np.asarray(c, np.float64))
        n = np.asarray(bshape, np.float64)
        ok = np.all((pts >= 0) & (pts <= n - 1), axis=-1)
    else:
        ok = valid > 0.5
    safe = np.maximum(valid, 0.05)[..., None]
    return np.where(ok[..., None], data / safe, np.asarray(fill, np.float64))

