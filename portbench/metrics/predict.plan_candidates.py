"""predict.plan_candidates: the shear planner's candidate factorisations
(counter `shear_plan.candidates`, one per `_finish_plan` call: up to 36
for each of a view's stack and remap plans) a volume, mean over the
traced volumes' planning spans."""

from portbench import spans


def read(rec):
    plans = spans.named(rec, "predict.plan", "predict")
    if not plans:
        return None
    return sum(r["counters"].get("shear_plan.candidates", 0)
               for r in plans) / len(plans)
