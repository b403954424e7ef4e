"""The host half of the shear-pass kernel's tiling (`ops/shear_pass.py:
tile_plan`), held against float32 positions on the CPU.

The kernel copies, per tile, the source lines between the taps of the
tile's corner positions into shared memory, and sizes that window with the
host's bound. These tests enumerate every tile of every pass of the main
path's 256^3 and 512^3 view plans and of random plans over all six (m, q)
layouts (plus q = none), take each tile's window from its corners as the
kernel does, and require that every in-range tap of every output of the
tile lies inside it, that the window holds at most `r_max` lines, and that
a block's shared memory stays within Hopper's 227 KB.
"""

import functools

import numpy as np
import pytest
import torch

from multiplanarunet_tpu_torch.image.volume_sampler import VolumeSampler
from multiplanarunet_tpu_torch.ops import geometry
from multiplanarunet_tpu_torch.ops.shear_plan import _Op, plan_affine_resample
from multiplanarunet_tpu_torch.ops.shear_pass import (
    SMEM_LIMIT,
    pass_positions,
    tap_parts,
    tile_plan,
)
from multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict import (
    MultiViewPredictor,
)
from tests.torch_projects import torch_threads  # noqa: F401

_BIG = 1 << 40


class _Image:
    """Shape and affine of a volume; the planner reads nothing else."""

    def __init__(self, dim):
        shape = (dim, dim, dim, 1)
        self.shape = shape
        self.affine = np.eye(4)
        self.interpolator = VolumeSampler(
            np.broadcast_to(np.zeros(1, np.float32), shape), self.affine)


@functools.lru_cache(maxsize=None)
def _main_path_passes(dim):
    """[(stage shape without C, op, plan kind)] of every pass of the 6-view
    stack and remap plans of a dim^3 volume, as predict_image plans them
    (bench.py's views and `same+20` planes)."""
    pred = MultiViewPredictor(torch.nn.Identity(), sample_dim=dim,
                              real_space_span=float(dim - 1), n_classes=7,
                              device=torch.device("cpu"))
    img = _Image(dim)
    views = geometry.sample_random_views_with_angle_restriction(
        6, 60, rng=np.random.RandomState(42))
    offsets, n_valid = pred._prepare_offsets(img, "same+20")
    bases = [geometry.plane_basis(v) for v in views]
    Mts = [pred._remap_transform(img, b, (dim,) * 3) for b in bases]
    out = []
    for (s_plan, _), (_, _, r_plan, _) in pred._plan_shear_views(
            img, bases, Mts, offsets, n_valid):
        for kind, plan in (("stack", s_plan), ("remap", r_plan)):
            for i, op in enumerate(plan.ops):
                shape = tuple(e for (_, e) in plan.stages[i])
                out.append((shape, op, kind))
    return out


@functools.lru_cache(maxsize=None)
def _random_passes():
    """Every pass of random affine plans (all six (m, q) layouts of the
    planner), and one pass per axis with q = none."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(4):
        Q, _ = np.linalg.qr(rng.randn(3, 3))
        N = Q @ np.diag(1.0 + (rng.rand(3) * 0.8 - 0.3))
        src = tuple(int(s) for s in rng.randint(24, 72, 3))
        dst = tuple(int(s) for s in rng.randint(24, 72, 3))
        c = np.asarray(src) / 2.0 - N @ (np.asarray(dst) / 2.0)
        plan = plan_affine_resample(N, c, src, dst)
        for i, op in enumerate(plan.ops):
            out.append((tuple(e for (_, e) in plan.stages[i]), op, "random"))
    for m in range(3):
        op = _Op(m, None, -1.17 + 0.4 * m, 0.0)
        op.gamma, op.in_lo, op.in_extent = 3.3, 0, 40 + m
        op.out_lo, op.out_extent, op.q_lo = -2, 36 + 5 * m, 0
        shape = [31, 29, 27]
        shape[m] = op.in_extent
        out.append((tuple(shape), op, "q none"))
    return out


def _q_ranges(shape, op, tp, C):
    """(first, last) q index of every tile's rows or columns, in the
    kernel's tiling."""
    S0, S1, S2 = shape
    if op.q is None:
        return np.zeros(1, np.int64), np.zeros(1, np.int64)
    if op.m == 2:
        if op.q == 0:  # q index = i0, one per tile
            qa = np.arange(S0)
            return qa, qa
        qa = np.arange(0, S1, tp.rb)  # a tile's rows i1 .. i1 + rb - 1
        return qa, np.minimum(qa + tp.rb, S1) - 1
    if op.q == 2:  # q index = column // C over a chunk of iw columns
        W = S2 * C
        c0 = np.arange(0, W, tp.iw)
        return c0 // C, (np.minimum(c0 + tp.iw, W) - 1) // C
    qa = np.arange(shape[op.q])  # q index = the tile's row
    return qa, qa


def _range_reduce(x, qa, qb, ufunc):
    """ufunc.reduce of x's rows qa[i]..qb[i] for every range (ranges may
    overlap by a row)."""
    x = np.concatenate([x, x[:1]])  # a row past the end for reduceat
    idx = np.stack([qa, qb + 1], axis=1).reshape(-1)
    return ufunc.reduceat(x, idx, axis=0)[::2]


def _check_pass(shape, op, method, C, dtype):
    """Every in-range tap of every output lies inside its tile's window,
    the window holds at most r_max lines, and shared memory fits."""
    tp = tile_plan(shape + (C,), op, method, dtype)
    assert tp.smem <= SMEM_LIMIT
    m, q = op.m, op.q
    L_in, T = shape[m], int(op.out_extent)
    n_q = shape[q] if q is not None else 1
    pos = pass_positions(op, n_q, "cpu").numpy()  # (n_q, T) float32
    taps = [i.numpy() for i, _ in tap_parts(torch.from_numpy(pos), method)]
    lo, hi = np.maximum(taps[0], 0), np.minimum(taps[-1], L_in - 1)
    some = lo <= hi  # the output has an in-range tap
    lo, hi = np.where(some, lo, _BIG), np.where(some, hi, -_BIG)

    # Each tile's in-range taps: t-tiles, then the tile's q range
    n_t = -(-T // tp.tt)
    pad = n_t * tp.tt - T
    lo = np.pad(lo, ((0, 0), (0, pad)), constant_values=_BIG)
    hi = np.pad(hi, ((0, 0), (0, pad)), constant_values=-_BIG)
    lo = lo.reshape(n_q, n_t, tp.tt).min(-1)
    hi = hi.reshape(n_q, n_t, tp.tt).max(-1)
    qa, qb = _q_ranges(shape, op, tp, C)
    assert (qb - qa).max() <= tp.q_span
    lo = _range_reduce(lo, qa, qb, np.minimum)
    hi = _range_reduce(hi, qa, qb, np.maximum)

    # The window the kernel takes from the tile's corner positions
    t0 = np.arange(n_t) * tp.tt
    t1 = np.minimum(t0 + tp.tt, T) - 1
    corners = np.stack([pos[qa][:, t0], pos[qa][:, t1],
                        pos[qb][:, t0], pos[qb][:, t1]])
    first = -1 if method == "cubic" else 0
    last = 2 if method == "cubic" else 1
    s_lo = np.maximum(np.floor(corners.min(0)).astype(np.int64) + first, 0)
    s_lo &= ~(tp.align - 1)
    s_hi = np.minimum(np.floor(corners.max(0)).astype(np.int64) + last,
                      L_in - 1)
    need = lo <= hi
    assert need.any()
    assert (lo[need] >= s_lo[need]).all()
    assert (hi[need] <= s_hi[need]).all()
    assert (s_hi - s_lo + 1).max() <= tp.r_max
    return tp


# (method, channels, dtype): the stack and remap of the main path, the
# grouped remap's groups of 2 and 4 classes, and float32 passes
_VARIANTS = [("cubic", 2, torch.bfloat16), ("linear", 8, torch.bfloat16),
             ("linear", 3, torch.bfloat16), ("linear", 5, torch.bfloat16),
             ("cubic", 3, torch.float32), ("linear", 8, torch.float32)]


@pytest.mark.parametrize("dim", [256, 512])
@pytest.mark.parametrize("kind", ["stack", "remap"])
def test_main_path_taps_inside_tile_windows(dim, kind):
    method, C = ("cubic", 2) if kind == "stack" else ("linear", 8)
    passes = [p for p in _main_path_passes(dim) if p[2] == kind]
    assert len(passes) == 36
    for shape, op, _ in passes:
        _check_pass(shape, op, method, C, torch.bfloat16)
        if kind == "remap":  # the grouped remap's channel groups
            _check_pass(shape, op, method, 3, torch.bfloat16)


@pytest.mark.parametrize("method, C, dtype", _VARIANTS)
def test_random_plans_taps_inside_tile_windows(method, C, dtype):
    passes = _random_passes()
    layouts = {(op.m, op.q) for _, op, _ in passes}
    assert layouts == {(1, 0), (2, 0), (2, 1), (0, 1), (0, 2), (1, 2),
                       (0, None), (1, None), (2, None)}
    for shape, op, _ in passes:
        _check_pass(shape, op, method, C, dtype)


@pytest.mark.parametrize("C", [2, 3, 5, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_shared_memory_within_hopper_limit(C, dtype):
    """Every main-path pass at 256^3 and 512^3 fits a block's 227 KB,
    with 16-byte vectors where the layout allows them."""
    V = 16 // (4 if dtype == torch.float32 else 2)
    for dim in (256, 512):
        for shape, op, kind in _main_path_passes(dim):
            method = "cubic" if kind == "stack" else "linear"
            tp = tile_plan(shape + (C,), op, method, dtype)
            assert tp.smem <= SMEM_LIMIT
            assert tp.rb * tp.tt * C < 1 << 30
            if C % V == 0:  # one position per vector on every layout
                assert tp.ep == V
            if C == 2 and op.m == 2:
                assert tp.ep == 2
