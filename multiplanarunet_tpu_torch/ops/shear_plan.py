"""Shear-decomposition planner (numpy): factor an affine resample into six
elementary single-axis passes and size every intermediate stage.

A numpy copy of the planner half of `multiplanarunet_tpu/ops/shear.py`
(`_Op` .. `plan_affine_resample`, `plan_plane_stack`, `plan_view_remap`).
That module imports jax above its numpy planner, so the port carries this
copy; tests/test_torch_shear.py requires its plans to be identical to the
JAX package's (ops, coefficients, perms and stage extents).

Each pass resamples axis `m` at ``alpha * t + beta * v[q] + gamma`` where
`q` is one other axis; `ops/shear_pass.py` executes one pass and
`ops/shear.py` a whole plan.
"""

from __future__ import annotations

from itertools import permutations

import numpy as np

from multiplanarunet_tpu_torch.utils import trace


class _Op:
    """One elementary pass: resample axis `m` at alpha*t + beta*v[q] + gamma.

    All geometry is resolved at plan time."""

    __slots__ = ("m", "q", "alpha", "beta", "gamma",
                 "in_extent", "in_lo", "out_extent", "out_lo", "q_lo")

    def __init__(self, m, q, alpha, beta):
        self.m, self.q = m, q
        self.alpha, self.beta = float(alpha), float(beta)
        self.gamma = 0.0

    def matrix(self):
        M = np.eye(3)
        M[self.m, self.m] = self.alpha
        if self.q is not None:
            M[self.m, self.q] = self.beta
        return M

    def __repr__(self):
        return (f"Op(m={self.m}, q={self.q}, a={self.alpha:.4f}, "
                f"b={self.beta:.4f}, g={self.gamma:.4f}, "
                f"in={getattr(self, 'in_extent', '?')}"
                f"@{getattr(self, 'in_lo', '?')}, "
                f"out={getattr(self, 'out_extent', '?')}"
                f"@{getattr(self, 'out_lo', '?')})")


_ELIM_ORDER = [(1, 0), (2, 0), (2, 1), (0, 1), (0, 2), (1, 2)]
# The last op touching each row also carries that row's scale (alpha), so
# a general affine is SIX passes, not 6 shears + 3 scales.
_FINAL_FOR_ROW = {(2, 1), (0, 2), (1, 2)}


def _peel(Np):
    """Factor Np = E(1,0) E(2,0) E(2,1) E(0,1) E(0,2) E(1,2), the product
    taken in EXECUTION order (first executed = leftmost factor). Row-
    reduction of Np to the identity gives the coefficients. Returns
    (ops, ok)."""
    R = np.array(Np, np.float64)
    ops = []
    for (m, q) in _ELIM_ORDER:
        piv = R[q, q]
        if abs(piv) < 1e-9:
            return None, False
        beta = R[m, q] / piv
        R[m, :] = R[m, :] - beta * R[q, :]
        alpha = 1.0
        if (m, q) in _FINAL_FOR_ROW:
            alpha = R[m, m]
            if abs(alpha) < 1e-9:
                return None, False
            R[m, :] = R[m, :] / alpha
        ops.append(_Op(m, q, alpha, beta))
    off = R - np.eye(3)
    if np.max(np.abs(off)) > 1e-6 * max(1.0, float(np.max(np.abs(Np)))):
        return None, False
    return ops, True


def _compose(ops):
    """Composite (M, t): A_K[v] = A_0[M v + t] for ops in execution order."""
    M = np.eye(3)
    t = np.zeros(3)
    for op in ops:
        E = op.matrix()
        g = np.zeros(3)
        g[op.m] = op.gamma
        t = M @ g + t
        M = M @ E
    return M, t


def factor_affine(N):
    """Pick a row permutation + elementary-op sequence whose composite
    matrix equals N[perm, :], minimizing the largest |coefficient|.
    Returns (perm, ops) or (None, None)."""
    N = np.asarray(N, np.float64)
    best = None
    for perm in permutations(range(3)):
        ops, ok = _peel(N[list(perm), :])
        if not ok:
            continue
        worst = max(
            max(abs(o.beta) for o in ops),
            max(max(abs(o.alpha), 1.0 / abs(o.alpha)) for o in ops),
        )
        if best is None or worst < best[0]:
            best = (worst, perm, ops)
    if best is None:
        return None, None
    return best[1], best[2]


class ShearPlan:
    """Static execution plan for one (N, c, src_shape, out_shape) resample."""

    __slots__ = ("perm", "out_perm", "ops", "src_shape", "out_shape",
                 "src_t_shape", "valid", "stages")

    def __repr__(self):
        body = "\n  ".join(repr(o) for o in self.ops)
        return (f"ShearPlan(perm={self.perm}, out_perm={self.out_perm}, "
                f"valid={self.valid},\n  {body})")


def _finish_plan(plan, perm, out_perm, ops, c_rp, out_shape_p, round_extent):
    """Solve translations + interval bookkeeping for one factorization.
    `out_shape_p` is the PLANNED (column-permuted) output box; plan.out_shape
    stays the true one (the executor transposes back at the end). Each
    call is a candidate of the search: counter `shear_plan.candidates`."""
    trace.count("shear_plan.candidates")
    plan.perm = perm
    plan.out_perm = out_perm
    plan.ops = ops

    # Solve gammas for the translation on one op per output axis (the last
    # op touching each axis; their translation effects span R^3)
    gamma_ops, seen = [], set()
    for op in reversed(ops):
        if op.m not in seen:
            seen.add(op.m)
            gamma_ops.append(op)
    _, base_t = _compose(ops)
    cols = []
    for g_op in gamma_ops:
        g_op.gamma = 1.0
        _, t1 = _compose(ops)
        cols.append(t1 - base_t)
        g_op.gamma = 0.0
    gammas = np.linalg.solve(np.stack(cols, axis=1), c_rp - base_t)
    for g_op, g in zip(gamma_ops, gammas):
        g_op.gamma = float(g)

    src_t_shape = tuple(plan.src_shape[p] for p in perm)
    plan.src_t_shape = src_t_shape
    K = len(ops)

    # Backward need B[i]: indices stage i must answer for. Margins cover the
    # widest tap footprint (cubic: [floor(pos)-1, floor(pos)+2]).
    B = [None] * (K + 1)
    B[K] = [(0.0, float(out_shape_p[a] - 1)) for a in range(3)]
    for i in range(K, 0, -1):
        op = ops[i - 1]
        prev = list(B[i])
        vm = B[i][op.m]
        vq = B[i][op.q] if op.q is not None else (0.0, 0.0)
        cands_m = [op.alpha * vm[0], op.alpha * vm[1]]
        cands_q = [op.beta * vq[0], op.beta * vq[1]]
        lo = min(cands_m) + min(cands_q) + op.gamma - 1.0
        hi = max(cands_m) + max(cands_q) + op.gamma + 2.0
        prev[op.m] = (np.floor(lo), np.ceil(hi))
        B[i - 1] = prev

    # Forward data D[i]: indices of stage i that can hold real data
    D = [None] * (K + 1)
    D[0] = [(0.0, float(src_t_shape[a] - 1)) for a in range(3)]
    for i in range(1, K + 1):
        op = ops[i - 1]
        cur = list(D[i - 1])
        sm = D[i - 1][op.m]
        vq = cur[op.q] if op.q is not None else (0.0, 0.0)
        lo = sm[0] - max(op.beta * vq[0], op.beta * vq[1]) - op.gamma
        hi = sm[1] - min(op.beta * vq[0], op.beta * vq[1]) - op.gamma
        lo, hi = sorted((lo / op.alpha, hi / op.alpha))
        cur[op.m] = (np.floor(lo) - 2.0, np.ceil(hi) + 2.0)
        D[i] = cur

    # Desired stored interval per stage/axis = B ∩ D (clamped non-empty)
    want = []
    for i in range(K + 1):
        row = []
        for a in range(3):
            lo = max(B[i][a][0], D[i][a][0])
            hi = min(B[i][a][1], D[i][a][1])
            if hi < lo:
                lo, hi = 0.0, 1.0
            row.append((lo, hi))
        want.append(row)
    # Boundary stages are fixed: A_0 = transposed source, A_K = output box
    want[0] = [(0.0, float(src_t_shape[a] - 1)) for a in range(3)]
    want[K] = [(0.0, float(out_shape_p[a] - 1)) for a in range(3)]

    # An op only changes its own axis, so along every other axis the stored
    # window must be IDENTICAL between consecutive stages. For each axis,
    # stages split into segments at the passes acting on it; within a
    # segment use the union of wants (boundary stages pin their segment).
    stages = [[None] * 3 for _ in range(K + 1)]
    for a in range(3):
        seg_start = 0
        boundaries = [i + 1 for i, op in enumerate(ops) if op.m == a]
        for seg_end in boundaries + [K + 1]:
            seg = range(seg_start, min(seg_end, K + 1))
            lo = min(want[i][a][0] for i in seg)
            hi = max(want[i][a][1] for i in seg)
            lo_i = int(np.floor(lo))
            length = int(np.ceil(hi)) - lo_i + 1
            if round_extent and 0 not in seg and K not in seg:
                length = -(-length // round_extent) * round_extent
            if 0 in seg:
                lo_i, length = 0, src_t_shape[a]
            if K in seg:
                lo_i, length = 0, out_shape_p[a]
            for i in seg:
                stages[i][a] = (lo_i, length)
            seg_start = seg_end
    plan.stages = stages

    for i, op in enumerate(ops):
        op.in_lo, op.in_extent = stages[i][op.m]
        op.out_lo, op.out_extent = stages[i + 1][op.m]
        op.q_lo = stages[i + 1][op.q][0] if op.q is not None else 0
    return plan


def plan_affine_resample(N, c, src_shape, out_shape, round_extent=16):
    """Plan passes realizing out[v] = src[N v + c] (fill outside).

    N, c take an OUTPUT index to a SOURCE fractional index. Intermediate
    extents round up to `round_extent`. plan.valid False => numerically
    singular.

    Searches all (source-axis, output-axis) permutation pairs and keeps the
    factorization with the smallest total stage footprint (the passes are
    bandwidth-bound, so stage voxels ~ runtime), alias-free ones first.

    The score is (alias tier, footprint) and the tier is known from `_peel`
    alone, so the search peels every pair, then finishes tier by tier from
    the lowest and stops at the first tier that holds a finished candidate:
    the plan the exhaustive search picks, with ties still going to the
    first pair in enumeration order. Counters: `shear_plan.candidates`
    (finished) and `shear_plan.pruned` (factored, never finished).
    """
    N = np.asarray(N, np.float64)
    c = np.asarray(c, np.float64)
    plan = ShearPlan()
    plan.src_shape = tuple(int(s) for s in src_shape)
    plan.out_shape = tuple(int(s) for s in out_shape)

    # (alias tier, out_perm, perm, ops, out_shape_p) of each pair that
    # factors, in enumeration order. A pass with |alpha| > 1 subsamples
    # its axis, so alias-free factorizations win outright.
    cands = []
    for out_perm in permutations(range(3)):
        Nc = N[:, list(out_perm)]
        out_shape_p = tuple(plan.out_shape[k] for k in out_perm)
        for perm in permutations(range(3)):
            ops, ok = _peel(Nc[list(perm), :])
            if not ok:
                continue
            alias = max(1.0, max(abs(o.alpha) for o in ops))
            cands.append((round(alias, 6), out_perm, perm, ops, out_shape_p))
    # Stable: enumeration order within a tier.
    cands.sort(key=lambda k: k[0])

    best = None
    finished = 0
    for alias, out_perm, perm, ops, out_shape_p in cands:
        if best is not None and alias != best[0][0]:
            break
        finished += 1
        cand = ShearPlan()
        cand.src_shape = plan.src_shape
        cand.out_shape = plan.out_shape
        cand.valid = True
        try:
            _finish_plan(cand, perm, out_perm, ops, c[list(perm)],
                         out_shape_p, round_extent)
        except np.linalg.LinAlgError:
            continue
        # Float math: ill-conditioned candidates produce extents that
        # overflow int64.
        cost = sum(
            float(np.prod([float(e) for (_, e) in st]))
            for st in cand.stages
        )
        score = (alias, cost)
        if best is None or score < best[0]:
            best = (score, cand)
    trace.count("shear_plan.pruned", len(cands) - finished)
    if best is None:
        plan.valid = False
        plan.perm, plan.out_perm, plan.ops, plan.stages = None, None, [], []
        return plan
    return best[1]


def plan_plane_stack(basis, rot, origin, spacing, g0, g_step, o0, o_step,
                     vol_shape, dim, n_planes):
    """Plan the FORWARD resample: volume (X,Y,Z) -> oblique plane stack
    (dim, dim, n_planes). Plane sample (i, j, p) sits at real position
    u*(g0+i*g_step) + v*(g0+j*g_step) + n_hat*(o0+p*o_step), rotated by
    `rot` and converted to voxel indices via (pos - origin)/spacing.

    Returns (plan, (N, c)) for shear_resample(exact_bounds=(N, c))."""
    basis = np.asarray(basis, np.float64)
    rot = np.asarray(rot, np.float64)
    origin = np.asarray(origin, np.float64)
    spacing = np.asarray(spacing, np.float64)
    B = basis  # columns u, v, n_hat
    steps = np.diag([g_step, g_step, o_step])
    starts = B @ np.array([g0, g0, o0])
    N = (1.0 / spacing)[:, None] * (rot @ B @ steps)
    c = (rot @ starts - origin) / spacing
    plan = plan_affine_resample(N, c, vol_shape,
                                (int(dim), int(dim), int(n_planes)))
    return plan, (N, c)


def plan_view_remap(M, t, g0, g_step, o0, o_step, pred_shape, out_shape):
    """Plan the BACKWARD resample: prediction stack (d, d, P) -> voxel grid.
    Voxel index v maps to plane coords M v + t; plane coords convert to
    stack indices via (coord - (g0, g0, o0)) / (g_step, g_step, o_step).

    Returns (plan, (N, c))."""
    M = np.asarray(M, np.float64)
    t = np.asarray(t, np.float64)
    starts = np.array([g0, g0, o0], np.float64)
    steps = np.array([g_step, g_step, o_step], np.float64)
    N = M / steps[:, None]
    c = (t - starts) / steps
    plan = plan_affine_resample(N, c, pred_shape, out_shape)
    return plan, (N, c)


def plan_stage_bytes(plan, n_channels, bytes_per=2):
    """Largest intermediate stage of a plan in bytes (bf16 passes by
    default, +1 channel for validity). Float math: degenerate plans can
    have extents whose product overflows int64."""
    return max(
        float(np.prod([float(ext) for (_, ext) in stage]))
        for stage in plan.stages
    ) * (n_channels + 1) * bytes_per
