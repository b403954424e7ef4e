"""The numbers that decide `correct`: how far what the program produced
lies from the reference. Each is 0 for a perfect match and grows with
the fault; `portbench/workloads/<cell>.json` holds each one's limit."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import sampler

# The check adds window volumes (at most MAX_VOLUMES) until the fp8
# reference's mean gap over them reaches GAP_FLOOR: on one volume fp8 may
# move the class map by little (24 seeds read 5.3e-5 and up, two later
# volumes 1.3e-5 and 4.0e-5), and a ratio of a few flipped voxels swings
GAP_FLOOR = 5e-5
MAX_VOLUMES = 3


@torch.no_grad()
def class_map_gaps(cls, score):
    """Readings of a class map (X, Y, Z) against the reference's fused
    scores (X, Y, Z, n_classes): per voxel the gap by which the score of
    the program's class lies below the reference's best. Returns
    {gap_mean, gap_p999, gap_max, disagree}: the mean gap over voxels,
    its 99.9th percentile, its largest, and the share of voxels whose
    class is not the reference's best."""
    cls = torch.as_tensor(cls, device=score.device).long()
    best = score.max(dim=-1).values
    chosen = score.gather(-1, cls[..., None])[..., 0]
    gap = (best - chosen).flatten()
    del best, chosen
    n = gap.numel()
    top = gap.topk(max(1, n // 1000)).values  # the largest 0.1%
    return {"gap_mean": float(gap.double().mean()),
            "gap_p999": float(top[-1]), "gap_max": float(top[0]),
            "disagree": float((gap > 0).double().mean())}


def leaf_gaps(prog, ref, keep):
    """{path: gap} of each leaf in `keep`: |‖prog‖ - ‖ref‖| over the
    larger of ‖ref‖ and the median leaf's ‖ref‖. prog, ref: {path:
    tensor}."""
    ref_n = {p: float(ref[p].double().norm()) for p in keep}
    med = float(np.median(list(ref_n.values())))
    return {p: abs(float(prog[p].double().norm()) - ref_n[p])
            / max(ref_n[p], med) for p in keep}


def total_error(prog, ref, keep):
    """‖prog - ref‖ / ‖ref‖ over all the leaves in `keep` as one
    vector."""
    num = sum(float((prog[p] - ref[p]).double().norm()) ** 2
              for p in keep) ** 0.5
    den = sum(float(ref[p].double().norm()) ** 2 for p in keep) ** 0.5
    return num / den


def total_gap(prog, ref, keep):
    """|‖prog‖ - ‖ref‖| / ‖ref‖ over all the leaves in `keep` as one
    vector."""
    pn = sum(float(prog[p].double().norm()) ** 2 for p in keep) ** 0.5
    rn = sum(float(ref[p].double().norm()) ** 2 for p in keep) ** 0.5
    return abs(pn - rn) / rn


def moving_leaves(ref_grad, share=1e-3):
    """The leaves whose reference gradient norm is at least `share` of
    the median leaf's: the others (gradient nought to rounding) move
    under Adam by round-off alone and are not compared."""
    norms = {p: float(g.double().norm()) for p, g in ref_grad.items()}
    med = float(np.median(list(norms.values())))
    return [p for p, n in norms.items() if n >= share * med]


def step_readings(prog, ref, keep):
    """The training numbers of the program's first steps against the
    reference's over the same batches. prog, ref: (losses, first
    gradient, parameters after the last step); keep: {"leaves": the
    leaves compared, "p0": the parameters both started from,
    "last_block"}.

    loss_gap: the largest relative gap of a step's loss; loss1_gap: the
    first step's; grad_gap / grad_gap_median: the worst / median leaf's
    gap of the first gradient (`leaf_gaps`); grad_gap_total: the whole
    gradient's; grad_err_total: the whole first gradient's relative
    error (`total_error`); out_grad_err: that error over the leaves that
    no ReLU or max-pool lies behind in the backward (the out conv and the
    last block's BatchNorm), whose gradient is continuous in the
    forward's rounding; update_gap: the worst leaf's gap of the
    parameters' change over the steps; `keep["last_block"]` names the
    last decoder block."""
    p_loss, p_grad, p_after = prog
    r_loss, r_grad, r_after = ref
    leaves, p0 = keep["leaves"], keep["p0"]
    rel = [abs(a - b) / abs(b) for a, b in zip(p_loss, r_loss)]
    g = leaf_gaps(p_grad, r_grad, leaves)
    d_prog = {p: p_after[p] - p0[p] for p in leaves}
    d_ref = {p: r_after[p] - p0[p] for p in leaves}
    u = leaf_gaps(d_prog, d_ref, leaves)
    g_at, u_at = max(g, key=g.get), max(u, key=u.get)
    last = [p for p in leaves if p[0] == "out_conv"
            or p[:2] == (keep["last_block"], "bn")]
    numbers = {"loss_gap": max(rel), "loss1_gap": rel[0],
               "out_grad_err": total_error(p_grad, r_grad, last),
               "grad_gap": g[g_at],
               "grad_gap_median": float(np.median(list(g.values()))),
               "grad_gap_total": total_gap(p_grad, r_grad, leaves),
               "grad_err_total": total_error(p_grad, r_grad, leaves),
               "update_gap": u[u_at]}
    return numbers, {"grad_leaf": "/".join(g_at), "update_leaf":
                     "/".join(u_at)}


def gap_ratio(prog_sum, fp8_sum):
    """`gap_vs_fp8`: the program's summed gap over the fp8 reference's,
    on the same voxels; 0 where both are 0."""
    if fp8_sum > 0:
        return prog_sum / fp8_sum
    return 0.0 if prog_sum == 0 else float("inf")


@torch.no_grad()
def sampler_readings(batches, subjects, geometry, aug):
    """The training sampler's numbers over checked batches.

    batches: [(made, (x, y, w), fields)]: what the hooks recorded of a
    batch (`images` before the augmenter (B, *spatial, 1), `positions`,
    `subjects` per row, `draws` [(count, alphas, sigmas, mask)]), the
    batch the step got, and the augmenter's noise fields [(B, *spatial)
    per axis]. subjects: {identifier: (scaled volume, fill, labels,
    shape)}; geometry: {span, dim, real_box_dim (None for planes),
    affine}; aug: (the augmenter's seed, its kwargs).

    plane_err: the planes or boxes before the augmenter against the
    reference's read of the scaled subject at their positions, ‖prog -
    ref‖ over ‖ref - its mean‖; elastic_err: the batch's images against
    the reference's deformation E (its own draws of mask, alpha, sigma;
    the augmenter's noise fields) of the program's planes, ‖x - E‖ over
    ‖E - its mean‖ (a deformation skipped reads ‖planes - E‖ over that:
    how far the batches were deformed); label_err: the batch's
    labels that differ from the reference's deformation of its own
    labels at those positions, over the labels that the deformation
    changes (1 for a deformation skipped)."""
    seed, kw = aug
    s = dict.fromkeys(("plane", "ref", "ref2", "n", "el", "e", "e2", "bad",
                       "changed"), 0.0)
    draw_gap = 0.0
    boxes = geometry["real_box_dim"] is not None
    for made, (x, y, _), fields in batches:
        count, p_alpha, p_sigma, p_mask = made["draws"][0]
        B = x.shape[0]
        mask, alphas, sigmas = sampler.elastic_draws(
            seed, count, B, kw["alpha"], kw["sigma"], kw["apply_prob"])
        draw_gap = max(draw_gap, float(np.abs(alphas - p_alpha).max()),
                       float(np.abs(sigmas - p_sigma).max()),
                       float((mask != p_mask).any()))
        pos_a, pos_b = made["positions"]
        dev = x.device
        for b in range(B):
            scaled, fill, lab, shape = subjects[made["subjects"][b]]
            if boxes:
                pts = sampler.box_points(pos_a[b], pos_b[b],
                                         geometry["real_box_dim"],
                                         geometry["dim"], dev)
            else:
                pts = sampler.plane_points(pos_a[b], pos_b[b],
                                           geometry["span"],
                                           geometry["dim"], dev)
            t = sampler.voxel_coords(pts, geometry["affine"], shape)
            ref = sampler.read_linear(scaled, t, fill)
            ref_lab = sampler.read_nearest(lab, t, 0)
            planes = made["images"][b, ..., 0].double()
            s["plane"] += float(((planes - ref) ** 2).sum())
            s["ref"] += float(ref.sum())
            s["ref2"] += float((ref * ref).sum())
            s["n"] += ref.numel()
            if mask[b]:
                e_img, e_lab = sampler.elastic(
                    planes, ref_lab, [f[b] for f in fields],
                    float(alphas[b]), float(sigmas[b]), fill)
            else:
                e_img, e_lab = planes, ref_lab
            xb = x[b, ..., 0].double()
            yb = y[b].reshape(e_lab.shape).double()
            s["el"] += float(((xb - e_img) ** 2).sum())
            s["e"] += float(e_img.sum())
            s["e2"] += float((e_img * e_img).sum())
            s["bad"] += float((yb != e_lab).sum())
            s["changed"] += float((e_lab != ref_lab).sum())
    n = max(s["n"], 1)

    def rel(err2, total, total2):
        spread = max(total2 - total ** 2 / n, 0.0)
        return (err2 / spread) ** 0.5 if spread > 0 else float("inf")

    numbers = {"plane_err": rel(s["plane"], s["ref"], s["ref2"]),
               "elastic_err": rel(s["el"], s["e"], s["e2"]),
               "label_err": s["bad"] / max(s["changed"], 1.0)}
    return numbers, {"draws_gap": draw_gap,
                     "labels_changed": s["changed"],
                     "labels_differ": s["bad"]}
