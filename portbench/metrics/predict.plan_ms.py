"""predict.plan_ms: host milliseconds of the predictor's planning span
(`predict.plan`: plane offsets, view bases, remap transforms and the
shear plans of every view) a volume, mean over the traced volumes."""

from portbench import spans


def read(rec):
    return spans.mean([r["host_ms"] for r in
                       spans.named(rec, "predict.plan", "predict")])
