"""predict3d.gather_ms: device milliseconds a volume of pred_3D_iso's
`predict3d.gather` spans (CUDA events around each chunk's sampling the
boxes from the staged volume (`sample_box_batch`)), summed over the
volume's chunks, mean over the traced volumes."""

from portbench import span_sums


def read(rec):
    return span_sums.device_ms(rec, "predict3d.gather", "predict")
