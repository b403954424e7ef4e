"""predict3d.unet_ms: device milliseconds a volume of pred_3D_iso's
`predict3d.unet` spans (CUDA events around each chunk's the U-Net over
the boxes (`unet_predict_fn`)), summed over the volume's chunks, mean
over the traced volumes."""

from portbench import span_sums


def read(rec):
    return span_sums.device_ms(rec, "predict3d.unet", "predict")
