"""resample.roofline_pct: the resample layer's least time over its time
(stack + remap stages, CUDA events), in percent. The least time is the
larger of its bytes over the HBM bandwidth and its interpolation FLOPs
over the float32 peak, both counted from the work itself
(`portbench.arith.resample_work`), not from how the program does it."""

from portbench import arith


def read(rec):
    vols = [v for v in rec.get("volumes") or [] if "stack" in v["stage_ms"]]
    if not vols:
        return None
    least = sum(arith.least_seconds(v["resample_bytes"], v["resample_flops"])
                for v in vols)
    spent = sum(v["stage_ms"]["stack"] + v["stage_ms"]["remap"]
                for v in vols) / 1e3
    return 100.0 * least / spent
