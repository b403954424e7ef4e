"""mfu.predict3d: the 3D predict cell's share of the card's peak, the
U-Net's forward FLOPs of the window's volumes (every box of the base
tiling and the extra boxes, `arith.config_forward_flops` a box) over the
window's time, as a percent of the H100's 989 dense bf16 TFLOP/s."""

from portbench import arith


def read(rec):
    if rec.get("kind") != "predict" or not rec.get("attempted") \
            or "boxes_per_volume" not in rec:
        return None
    flops = rec["unet_flops_per_volume"] * rec["attempted"]
    return 100.0 * flops / rec["window_s"] / arith.PEAKS["bf16_flops"]
