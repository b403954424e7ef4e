"""mfu.train: 3 x the analytic forward FLOPs of every sample trained in
the window over the window's time, as a percent of the H100's 989 dense
bf16 TFLOP/s."""

from portbench import arith


def read(rec):
    if rec.get("kind") != "train" or not rec.get("samples"):
        return None
    flops = 3.0 * rec["forward_flops_per_sample"] * rec["samples"]
    return 100.0 * flops / rec["window_s"] / arith.PEAKS["bf16_flops"]
