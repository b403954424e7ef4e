"""mfu.train_swin: the Swin UNETR cell's share of the card's peak, 3 x
the forward FLOPs of every box trained in the window
(`arith_swin.forward_flops`: convs, linears, q k^T and p v at the padded
window grid) over the window's time, as a percent of the H100's 989
dense bf16 TFLOP/s."""

from portbench import arith


def read(rec):
    if rec.get("kind") != "train" or not rec.get("samples") \
            or "swin" not in rec:
        return None
    flops = 3.0 * rec["forward_flops_per_sample"] * rec["samples"]
    return 100.0 * flops / rec["window_s"] / arith.PEAKS["bf16_flops"]
