"""train.swin_encoder_ms: device milliseconds a traced step of the Swin
UNETR forward's `swin.encoder` spans (CUDA events around the patch
embedding and the four Swin stages), summed over the step, mean over the
traced steps."""

from portbench import span_sums


def read(rec):
    return span_sums.device_ms(rec, "swin.encoder", "train")
