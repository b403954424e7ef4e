"""predict.plan_pruned: the shear planner's factorisations that were
never finished because a lower alias tier won (counter
`shear_plan.pruned`) a volume, mean over the traced volumes' planning
spans; None where the planner has no such counter."""

from portbench import spans


def read(rec):
    plans = spans.named(rec, "predict.plan", "predict")
    return spans.mean([r["counters"].get("shear_plan.pruned")
                       for r in plans])
