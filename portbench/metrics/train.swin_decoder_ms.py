"""train.swin_decoder_ms: device milliseconds a traced step of the Swin
UNETR forward's `swin.decoder` spans (CUDA events around the residual
encoder blocks on the image and the stages' outputs, the up-blocks and
their residual blocks), summed over the step, mean over the traced
steps."""

from portbench import span_sums


def read(rec):
    return span_sums.device_ms(rec, "swin.decoder", "train")
