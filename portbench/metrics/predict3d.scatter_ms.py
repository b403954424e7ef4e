"""predict3d.scatter_ms: device milliseconds a volume of pred_3D_iso's
`predict3d.scatter` spans (CUDA events around each chunk's adding the
boxes' probabilities onto the accumulator (`scatter_box_pred`'s
`index_add_`)), summed over the volume's chunks, mean over the traced
volumes."""

from portbench import span_sums


def read(rec):
    return span_sums.device_ms(rec, "predict3d.scatter", "predict")
