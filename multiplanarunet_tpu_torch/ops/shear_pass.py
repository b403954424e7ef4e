"""One elementary shear pass: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of `multiplanarunet_tpu/ops/pallas_shear.py:pass_pallas` (and
of the take form of `ops/shear.py:_pass_jnp`). A pass resamples axis
`op.m` of a rank-4 array (S0, S1, S2, C), channels last with the validity
channel last, at positions

    pos(t, b) = alpha * (t + out_lo) + gamma - in_lo + beta * (b + q_lo)

where t runs along the output's axis m and b along axis `op.q`, summing
the 2 (linear) or 4 (Catmull-Rom) taps around floor(pos) in float32; taps
outside [0, L_in) weigh 0.

`shear_pass` runs the plain version only for a tensor on the CPU. For a
CUDA tensor it launches `csrc/shear_pass.cu` and counts the launch in
`shear_pass.launches`, or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from multiplanarunet_tpu_torch.ops._build import kernels

_TAPS = {"linear": 2, "cubic": 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class KernelLaunchError(RuntimeError):
    """A CUDA kernel launch returned an error code."""


def _f32(x):
    """A Python float holding x rounded to float32 (the kernel's argument
    and the plain version's scalar are then the same number)."""
    return float(np.float32(x))


def pass_positions(op, n_q, device):
    """(n_q, L_out) float32 source positions, in the evaluation order of
    the JAX package's `_pass_positions` (a floor boundary flips a tap)."""
    t = torch.arange(op.out_extent, dtype=torch.float32, device=device)
    pos = (t + _f32(op.out_lo)) * _f32(op.alpha)
    pos = (pos + _f32(op.gamma)) - _f32(op.in_lo)
    if op.q is None:
        return pos[None, :]
    b = torch.arange(n_q, dtype=torch.float32, device=device) + _f32(op.q_lo)
    return pos[None, :] + b[:, None] * _f32(op.beta)


def tap_parts(pos, method):
    """[(index int64, weight float32)] taps at positions `pos` (the JAX
    package's `_tap_parts` for linear and cubic)."""
    i0f = torch.floor(pos)
    f = pos - i0f
    idx0 = i0f.to(torch.int64)
    if method == "linear":
        return [(idx0, 1.0 - f), (idx0 + 1, f)]
    f2 = f * f
    f3 = f2 * f
    return [
        (idx0 - 1, (f * -0.5 + f2) - f3 * 0.5),
        (idx0, (1.0 - f2 * 2.5) + f3 * 1.5),
        (idx0 + 1, (f * 0.5 + f2 * 2.0) - f3 * 1.5),
        (idx0 + 2, f2 * -0.5 + f3 * 0.5),
    ]


def _lift(x, m, q):
    """(n_q, L_out) plane -> rank-4 broadcast form with L_out at axis m and
    n_q at axis q (1 elsewhere)."""
    shape = [1, 1, 1, 1]
    shape[m] = x.shape[1]
    if q is None:
        return x.reshape(shape)
    shape[q] = x.shape[0]
    if q > m:
        x = x.T  # flat order must follow increasing axis order
    return x.reshape(shape)


def shear_pass_reference(A, op, method):
    """Plain PyTorch version of the pass (gather form), on any device:
    same positions and tap weights as the kernel, taps summed in float32
    in tap order, result cast to A's dtype."""
    m, q = op.m, op.q
    L_in = A.shape[m]
    n_q = A.shape[q] if q is not None else 1
    x = A.float()
    pos = pass_positions(op, n_q, A.device)
    out = None
    for idx, w in tap_parts(pos, method):
        valid = (idx >= 0) & (idx < L_in)
        g = torch.take_along_dim(x, _lift(idx.clamp(0, L_in - 1), m, q),
                                 dim=m)
        term = g * _lift(w * valid, m, q)
        out = term if out is None else out + term
    return out.to(A.dtype)


def _check(A, op, method):
    if method not in _TAPS:
        raise ValueError(f"shear_pass supports methods {sorted(_TAPS)}; "
                         f"got {method!r}")
    if A.dim() != 4:
        raise ValueError(f"shear_pass takes a rank-4 (S0, S1, S2, C) "
                         f"tensor; got shape {tuple(A.shape)}")
    if A.dtype not in _DTYPE_CODE:
        raise TypeError(f"shear_pass takes float32 or bfloat16; got "
                        f"{A.dtype}")
    if not A.is_contiguous():
        raise ValueError("shear_pass takes a contiguous tensor")
    if op.m not in (0, 1, 2) or op.q == op.m:
        raise ValueError(f"bad pass axes m={op.m}, q={op.q}")
    if A.shape[op.m] != op.in_extent:
        raise ValueError(f"axis {op.m} holds {A.shape[op.m]} samples; the "
                         f"pass was planned for {op.in_extent}")


def shear_pass(A, op, method="linear"):
    """Apply one planned pass (`op`, an `ops.shear_plan._Op`) to A."""
    _check(A, op, method)
    if A.device.type == "cpu":
        return shear_pass_reference(A, op, method)
    if A.device.type != "cuda":
        raise ValueError(f"shear_pass runs on cpu or cuda; got {A.device}")
    out_shape = list(A.shape)
    out_shape[op.m] = int(op.out_extent)
    out = torch.empty(out_shape, dtype=A.dtype, device=A.device)
    fn = kernels().shear_pass
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), out.data_ptr(), _DTYPE_CODE[A.dtype],
                 _TAPS[method], *A.shape, *A.stride(),
                 op.m, -1 if op.q is None else op.q, int(op.out_extent),
                 _f32(op.alpha), _f32(op.beta), _f32(op.gamma),
                 _f32(op.out_lo), _f32(op.in_lo), _f32(op.q_lo), stream)
    if err != 0:
        raise KernelLaunchError(f"shear_pass kernel launch failed: "
                                f"cudaError {err}")
    shear_pass.launches += 1
    return out


shear_pass.launches = 0
