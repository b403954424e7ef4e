"""mfu.predict: the U-Net's forward FLOPs of the window's volumes (the
plain decoder's unpadded count, views x valid planes) over the window's
time, as a percent of the H100's 989 dense bf16 TFLOP/s."""

from portbench import arith


def read(rec):
    if rec.get("kind") != "predict" or not rec.get("attempted"):
        return None
    flops = rec["unet_flops_per_volume"] * rec["attempted"]
    return 100.0 * flops / rec["window_s"] / arith.PEAKS["bf16_flops"]
