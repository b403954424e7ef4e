"""predict3d.boxes: boxes through the U-Net a volume (counter
`predict3d.boxes` of pred_3D_iso's `predict3d.unet` spans), mean over
the traced volumes: the base tiling plus the extra boxes."""

from portbench import span_sums


def read(rec):
    return span_sums.counter(rec, "predict3d.unet", "predict",
                             "predict3d.boxes")
