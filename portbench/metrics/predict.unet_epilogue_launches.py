"""predict.unet_epilogue_launches: launches of the U-Net's conv epilogue
kernel (counter `unet.epilogue`, one per launch of
csrc/unet_epilogue.cu, 22 a chunk's forward of the 2D preset) a volume:
the counter summed over each traced volume's `predict.unet` spans (one a
view), mean over the volumes. None where no span carries the counter (a
program without the kernel)."""

from portbench import spans


def read(rec):
    per_volume, counted = {}, False
    for r in spans.named(rec, "predict.unet", "predict"):
        n = r["counters"].get("unet.epilogue")
        counted = counted or n is not None
        per_volume[r["request"]] = per_volume.get(r["request"], 0) + (n or 0)
    return sum(per_volume.values()) / len(per_volume) if counted else None
