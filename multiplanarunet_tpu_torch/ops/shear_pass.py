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
CUDA tensor it launches `csrc/shear_pass.cu` with the tile geometry of
`tile_plan` and counts the launch in `shear_pass.launches`, or raises.
"""

from __future__ import annotations

import math
from collections import namedtuple

import numpy as np
import torch

from multiplanarunet_tpu_torch.ops._build import KernelLaunchError, kernels

_TAPS = {"linear": 2, "cubic": 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Shared memory a block may use on Hopper, and the share this kernel aims
# for so that two blocks (each double-buffering its window) fit on an SM
SMEM_LIMIT = 232448
SMEM_BUDGET = 100 * 1024
# Bytes of a column chunk of one window line (m=0/1)
_LINE_BYTES = 512

TilePlan = namedtuple("TilePlan", [
    "ep",      # elements of a 16-byte vector sharing a position (1: scalar)
    "tt",      # outputs along m per tile
    "iw",      # columns per tile (m=0/1; a power of two)
    "rb",      # rows per tile (m=2; 1 otherwise)
    "q_span",  # largest (last - first) q index within a tile
    "r_max",   # window lines a tile may need (the host's bound)
    "pitch",   # shared-memory elements of one tile row's window
    "align",   # alignment of a window's first line (m=2 vectors)
    "smem",    # shared-memory bytes per block (two windows)
])


def _pow2_at_least(n):
    return 1 << max(0, int(n) - 1).bit_length()


def window_lines(alpha, beta, tt, q_span, taps, L_in, align):
    """Bound on the source lines a tile of `tt` outputs along m and
    `q_span` + 1 consecutive q indices can touch with its in-range taps.

    The float32 position is monotone in t and in the q index, so its
    extremes lie at the tile's corners and differ by at most
    |alpha|(tt-1) + |beta| q_span plus float32 rounding (below 1 at these
    magnitudes): floor(max) - floor(min) <= ceil(that span) + 1, plus TAPS
    - 1 more lines for the taps around floor(pos). The window never
    exceeds the axis; aligning its first line down adds align - 1."""
    span = abs(float(np.float32(alpha))) * (tt - 1)
    span += abs(float(np.float32(beta))) * q_span
    return min(math.ceil(span) + taps + 1, L_in) + align - 1


def tile_plan(shape, op, method, dtype, aligned=True):
    """Host half of the kernel: tile sizes, window bound and shared-memory
    bytes for one pass over a contiguous (S0, S1, S2, C) stage.

    m=0/1 tiles are `tt` outputs along m times `iw` columns of a line
    (i2*C + c) of one row; m=2 lines are only C wide, so its tiles are
    `rb` rows (i1) times `tt` outputs. Vectors are 16 bytes where the line
    widths allow and `aligned` (both pointers 16-byte aligned) holds;
    EP = V when a vector shares one position, 2 for two-channel positions
    along a line whose position varies, else 1 (the scalar form)."""
    S0, S1, S2, C = (int(s) for s in shape)
    m, q = op.m, op.q
    L_in, T = (S0, S1, S2)[m], int(op.out_extent)
    taps = _TAPS[method]
    esize = 4 if dtype == torch.float32 else 2
    V = 16 // esize
    beta = op.beta if q is not None else 0.0

    def fits(smem):
        return smem <= SMEM_BUDGET

    if m == 2:
        vec = aligned and (L_in * C) % V == 0 and (T * C) % V == 0
        ep = V if vec and C % V == 0 else 2 if vec and C == 2 else 1
        align = V // math.gcd(V, C) if ep > 1 else 1
        unit = V if ep > 1 else 1
        tt = -(-T // 8) * 8
        while True:
            for rb in (32, 16, 8, 4, 2, 1):
                rb = min(rb, S1)
                q_span = rb - 1 if q == 1 else 0
                r_max = window_lines(op.alpha, beta, tt, q_span, taps, L_in,
                                     align)
                pitch = -(-(r_max * C) // unit) * unit
                smem = 2 * rb * pitch * esize
                if fits(smem) or (tt == 8 and rb == 1):
                    break
            if fits(smem) or tt == 8:
                break
            tt = max(8, -(-(tt // 2) // 8) * 8)
        iw = 1
    else:
        W = S2 * C
        vec = aligned and W % V == 0
        col = q == 2
        if not vec:
            ep = 1
        elif not col or C % V == 0:
            ep = V
        else:
            ep = 2 if C == 2 else 1
        iw = _LINE_BYTES // esize
        if col:
            iw = min(iw, _pow2_at_least(32 * C))
        iw = max(min(iw, _pow2_at_least(W)), V if ep > 1 else 1)
        q_span = -(-(iw - 1) // C) if col else 0
        align, rb = 1, 1
        for tt in (128, 64, 32, 16, 8):
            tt = min(tt, -(-T // 8) * 8)
            r_max = window_lines(op.alpha, beta, tt, q_span, taps, L_in, 1)
            pitch = r_max * iw
            smem = 2 * pitch * esize
            if fits(smem):
                break
    if smem > SMEM_LIMIT:
        raise ValueError(f"shear pass window needs {smem} bytes of shared "
                         f"memory per block (limit {SMEM_LIMIT})")
    return TilePlan(ep, tt, iw, rb, q_span, r_max, pitch, align, smem)


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
    aligned = A.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    tp = tile_plan(A.shape, op, method, A.dtype, aligned)
    fn = kernels().shear_pass
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), out.data_ptr(), _DTYPE_CODE[A.dtype],
                 _TAPS[method], *A.shape,
                 op.m, -1 if op.q is None else op.q, int(op.out_extent),
                 _f32(op.alpha), _f32(op.beta), _f32(op.gamma),
                 _f32(op.out_lo), _f32(op.in_lo), _f32(op.q_lo),
                 tp.tt, tp.iw, tp.rb, tp.r_max, tp.pitch, tp.align, tp.ep,
                 stream)
    if err != 0:
        raise KernelLaunchError(f"shear_pass kernel launch failed: "
                                f"cudaError {err}")
    shear_pass.launches += 1
    return out


shear_pass.launches = 0
