"""predict.unet_epilogue_cl_launches: launches of the U-Net's conv epilogue
kernel on a channels-last conv output (counter `unet.epilogue_cl`, one per
launch of csrc/unet_epilogue.cu whose rows are one element long) a volume:
the counter summed over each traced volume's `predict.unet` spans (one a
view), mean over the volumes. It equals `predict.unet_epilogue_launches`
where every conv of the predictor's U-Net keeps cuDNN's NHWC layout. None
where no span carries the counter (a program without it)."""

from portbench import span_sums


def read(rec):
    return span_sums.counter(rec, "predict.unet", "predict",
                             "unet.epilogue_cl")
